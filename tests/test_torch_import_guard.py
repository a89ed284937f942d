"""The port imports neither jax nor any module of the JAX reference.

Checked in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py)."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import hfnet_slam_torch
names = [m.name for m in pkgutil.walk_packages(hfnet_slam_torch.__path__, "hfnet_slam_torch.")]
for n in names:
    importlib.import_module(n)
{extra}
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "hfnet_slam_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _run(extra=""):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    return subprocess.run([sys.executable, "-c", _PROBE.format(extra=extra)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    r = _run()
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout  # every subpackage was walked


def test_chip_smoke_imports_without_jax():
    r = _run("import chip_smoke")
    assert r.returncode == 0, r.stdout + r.stderr


def test_card_tests_import_without_jax():
    """tests/test_torch_cuda.py runs on the GPU machine, which has no jax."""
    r = _run("sys.path.insert(0, 'tests'); import test_torch_cuda")
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_module_imports_yaml_or_pil():
    """The card's machine has neither PyYAML nor Pillow: the settings reader
    and the PNG reader are the port's own. No import statement anywhere in
    the port (function-local ones included) names them, and importing every
    module loads neither."""
    import ast

    root = os.path.join(REPO, "hfnet_slam_torch")
    found = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(d, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                             else [node.module or ""] if isinstance(node, ast.ImportFrom)
                             else [])
                    found += [(f, n) for n in names if n.split(".")[0] in ("yaml", "PIL")]
    assert not found, found
    r = _run("import hfnet_slam_torch.examples.run_euroc\n"
             "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('yaml', 'PIL'))\n"
             "sys.exit(3 if bad else 0)")
    assert r.returncode == 0, r.stdout + r.stderr


def test_frontend_modules_are_walked_without_jax():
    """The stream server, the viewers and the frontends' entry points are
    among the modules the probe imports (matplotlib, which the card's
    machine lacks, is imported by viewer.render only)."""
    want = ["hfnet_slam_torch.utils.stream", "hfnet_slam_torch.utils.viewer",
            "hfnet_slam_torch.utils.webviewer", "hfnet_slam_torch.examples.run_stream",
            "hfnet_slam_torch.examples.run_synthetic"]
    r = _run(f"missing = [n for n in {want!r} if n not in names]\n"
             "missing += sorted(k for k in sys.modules if k.startswith('matplotlib'))\n"
             "if missing:\n    print(missing)\n    sys.exit(4)")
    assert r.returncode == 0, r.stdout + r.stderr
