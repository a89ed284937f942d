"""The port's example entry points against the JAX reference's (port on the
CPU): examples/run_synthetic.py's browse run in both packages (tracked
counts within 2, ATE <= max(2 x reference, 0.01 m), tests/test_torch_async.py's
tolerances), the entry points' device rule, and the evaluation scripts'
syntax (they need datasets that are not here)."""
import importlib.util
import os
import subprocess

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_run_synthetic(monkeypatch, argv):
    """examples/run_synthetic.py's main() on argv: (tracked, ATE)."""
    from hfnet_slam_tpu.evaluation import ate

    spec = importlib.util.spec_from_file_location(
        "ref_run_synthetic", os.path.join(REPO, "examples", "run_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []
    real = ate.ate_rmse
    monkeypatch.setattr(ate, "ate_rmse", lambda e, g, **k: seen.append((len(e), real(e, g, **k)))
                        or seen[-1][1])
    monkeypatch.setattr("sys.argv", ["run_synthetic.py", *argv])
    assert mod.main() == 0
    return seen[-1][0], float(seen[-1][1])


def test_run_synthetic_browse_matches_reference(monkeypatch, capsys):
    from hfnet_slam_torch.examples import run_synthetic

    n_j, ate_j = _reference_run_synthetic(monkeypatch, ["--scene", "browse", "--frames", "30"])
    out = run_synthetic.main(["--scene", "browse", "--frames", "30", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"tracked {out['tracked']}/30 frames" in printed
    assert abs(out["tracked"] - n_j) <= 2 and out["tracked"] >= 10, (out, n_j)
    assert out["ate_m"] <= max(2 * ate_j, 0.01), (out, ate_j)


def test_run_synthetic_saves_its_trajectory(tmp_path):
    from hfnet_slam_torch.examples import run_synthetic

    path = tmp_path / "traj.txt"
    out = run_synthetic.main(["--scene", "corridor", "--frames", "12", "--device", "cpu",
                              "--save-trajectory", str(path)])
    assert out["tracked"] < 5 and out["ate_m"] is None  # the corridor initializes later
    assert path.exists()


@pytest.mark.parametrize("argv", [
    ("run_synthetic", ["--frames", "2"]),
    ("run_stream", ["--fake", "--frames", "2", "--port", "0"]),
])
def test_entry_points_without_device_need_cuda(argv, monkeypatch):
    """Without --device the entry points run on CUDA, and raise without it:
    nothing falls back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"hfnet_slam_torch.examples.{argv[0]}")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        mod.main(argv[1])


@pytest.mark.parametrize("script", ["eval_euroc.sh", "eval_tum_vi.sh", "eval_tum_rgbd.sh"])
def test_eval_scripts_parse_and_name_the_port(script):
    path = os.path.join(REPO, "hfnet_slam_torch", "examples", script)
    r = subprocess.run(["bash", "-n", path], capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    text = open(path).read()
    assert "python3 -m hfnet_slam_torch.examples.run_" in text
    assert "examples/run_" not in text.replace("hfnet_slam_torch.examples.run_", "")
    r = subprocess.run(["bash", path], capture_output=True, text=True, timeout=30)
    assert r.returncode != 0 and "dataset root" in r.stderr  # arguments are required
