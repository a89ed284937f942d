"""No module under slambench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
nothing under slambench/reference/ or slambench/frozen/ imports the
program."""
import ast
import os

SB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "hfnet_slam_tpu"}


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def _files(sub=""):
    for d, _, fs in os.walk(os.path.join(SB, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    seen = 0
    for p in _files():
        seen += 1
        assert not (_top_names(p) & FORBIDDEN), p
    assert seen > 10


def test_compares_top_level_names_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import hfnet_slam_torch.ops\nfrom hfnet_slam_tpu import x\n")
    assert _top_names(str(p)) == {"hfnet_slam_torch", "hfnet_slam_tpu"}
    assert not ({"hfnet_slam_torch"} & FORBIDDEN)


def test_reference_and_frozen_copies_import_no_program():
    seen = set()
    for sub in ("reference", "frozen"):
        for p in _files(sub):
            seen.add(os.path.relpath(p, SB))
            names = _top_names(p)
            assert "hfnet_slam_torch" not in names and not (names & FORBIDDEN), p
            with open(p) as f:
                assert "hfnet_slam_torch" not in f.read().replace(
                    "port's", "").split('"""', 2)[-1], p
    assert {"reference/loop.py", "frozen/ring.py"} <= seen
