"""Two real processes on the port's mesh layer (hfnet_slam_torch/parallel/),
mirroring tests/test_multihost_2proc.py: both join a torch.distributed gloo
group on localhost, build the (2 hosts x 2 shards) hybrid mesh, assemble a
sharded table from process-local rows and sum it across both processes;
then one distributed BA step and a sharded retrieval, each split over the
two processes (2 shards each), must give what one process with all 4 shards
gives: the same accept decision, poses within 1e-5, scores within 1e-6.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)

    coord, pid = sys.argv[1], int(sys.argv[2])
    from hfnet_slam_torch import lie
    from hfnet_slam_torch.geometry import cameras
    from hfnet_slam_torch.parallel import dist_ba, multihost, retrieval

    assert multihost.initialize(coordinator_address=coord, num_processes=2,
                                process_id=pid, backend="gloo")
    hm = multihost.make_hybrid_mesh(device="cpu", n_local=2)
    assert hm.shape == {"host": 2, "kf": 2}, hm.shape

    # a sharded table from process-local rows, summed across both processes
    N, D = 8, 4
    lo, hi = multihost.process_shard(N)
    assert (lo, hi) == ((0, 4) if pid == 0 else (4, 8))
    flat = multihost.make_mesh(device="cpu", n_local=2)
    rows = np.arange(lo, hi, dtype=np.float32)[:, None] * np.ones(D, np.float32)
    g = multihost.global_array(rows, flat)
    assert tuple(g.shape) == (2, 2, D)
    got = float(flat.psum(g.sum((1, 2))))
    assert got == float(np.arange(N).sum() * D), got

    # one distributed BA step: 4 shards over 2 processes against 1 process
    rng = np.random.default_rng(0)
    cam = cameras.pinhole(450.0, 450.0, 320.0, 240.0, 640, 480, device="cpu")
    M, K = 64, 4
    pts = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(6, 14, M)], 1)
    R = lie.so3_exp(torch.tensor(rng.normal(0, 0.02, (K, 3)), dtype=torch.float32)).numpy()
    t = (np.arange(K)[:, None] * np.array([0.3, 0.0, 0.0])).astype(np.float32)
    kf, pt = np.meshgrid(np.arange(K), np.arange(M), indexing="ij")
    kf, pt = kf.ravel(), pt.ravel()
    pc = np.einsum("eij,ej->ei", R[kf], pts[pt]) + t[kf]
    uv = cam.project(torch.tensor(pc, dtype=torch.float32)).numpy() + rng.normal(0, 0.3, (len(kf), 2))
    pts_n = (pts + rng.normal(0, 0.5, pts.shape)).astype(np.float32)
    fixed = np.arange(K) < 2
    E = len(kf)
    args = (4, K, 16, 128, R, t, fixed, pts_n, kf, pt, uv.astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool))
    prob, _ = dist_ba.partition_edges(*args, device="cpu")
    two = dist_ba.dist_lm_step(cam.kind, cam.params, prob, flat, lam=1e-3)
    one = dist_ba.dist_lm_step(cam.kind, cam.params, prob,
                               multihost.Mesh(torch.device("cpu"), 4), lam=1e-3)
    assert bool(two[5]) == bool(one[5])
    assert float(abs(two[1] - one[1]).max()) <= 1e-5
    assert abs(float(two[4]) - float(one[4])) <= 1e-5 * abs(float(one[4]))
    mine = flat.local_shards()
    assert float(abs(two[2][mine] - one[2][mine]).max()) <= 1e-4

    # sharded retrieval: each process scores its own shards
    table = rng.normal(size=(64, 16)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    db, vm = retrieval.make_sharded_db(flat, table, np.ones(64, bool))
    assert tuple(db.shape) == (2, 16, 16)
    idx, _ = retrieval.top_candidates(flat, table[:3], db, vm, n=2)
    assert idx[:, 0].tolist() == [0, 1, 2]
    multihost.shutdown()
    print(f"proc{pid} OK", flush=True)
""")


@pytest.mark.skipif(os.environ.get("HFNET_SKIP_2PROC") == "1", reason="2-process run disabled")
def test_two_process_gloo_runtime(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-2000:]}"
        assert f"proc{i} OK" in out
