"""The row_top2 kernel's 3xTF32 arithmetic (csrc/row_top2.cu), emulated in
plain PyTorch on the CPU, against float64 and the plain float32 matcher.

The kernel splits each float32 operand x into hi = tf32(x) and
lo = tf32(x - hi) (cvt.rna.tf32.f32: 10 mantissa bits, ties away from
zero) and, per k-step of 8, accumulates lo_A.hi_B, then hi_A.lo_B, then
hi_A.hi_B in float32; lo_A.lo_B is dropped. The emulation makes the same
split by bit arithmetic on the float32 view and sums the products in the
same order. It cannot reproduce the tensor core's rounding inside one
k-step, so it shows that the split keeps float32 accuracy, not the kernel's
bits; tests/test_torch_cuda.py and chip_smoke.py hold the kernel itself to
the plain version on the card.

Tolerances: the emulated similarity within 1e-6 of float64 (float32 over
<= 256 unit-norm terms is within ~1e-6; one TF32 pass misses by ~1e-4);
argmax equal to row_top2_reference's exactly on these inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hfnet_slam_torch.ops import bf_match as TB  # noqa: E402


def tf32_rna(x):
    """cvt.rna.tf32.f32 on float32 x: adding half a TF32 ulp to the
    sign-magnitude bits and clearing the low 13 rounds the magnitude to
    nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def sim_3xtf32(A, B):
    """A . B^T as the kernel sums it (D zero-padded to a multiple of 8)."""
    pad = (-A.shape[1]) % 8
    (ah, al), (bh, bl) = split(torch.nn.functional.pad(A, (0, pad))), \
        split(torch.nn.functional.pad(B, (0, pad)))
    acc = torch.zeros(A.shape[0], B.shape[0])
    for k in range(0, A.shape[1] + pad, 8):
        s = slice(k, k + 8)
        acc += al[:, s] @ bh[:, s].T
        acc += ah[:, s] @ bl[:, s].T
        acc += ah[:, s] @ bh[:, s].T
    return acc


def _problem(NA, NB, D, seed):
    """Unit descriptors; a quarter of B are noisy copies of A rows; a tenth
    of B masked."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((NA, D)).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    B = rng.standard_normal((NB, D)).astype(np.float32)
    n = min(NA, NB) // 4
    B[:n] = A[:n] + 0.03 * rng.standard_normal((n, D))
    B /= np.linalg.norm(B, axis=1, keepdims=True)
    return A, B, rng.uniform(size=NB) > 0.1


def test_split_is_tf32_and_keeps_float32_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(100000).astype(np.float32))
    hi, lo = split(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((x - hi) / x).abs().max()) <= 2.0 ** -11  # half a TF32 ulp
    x64 = x.double()
    assert float(((x64 - hi.double() - lo.double()) / x64).abs().max()) <= 2.0 ** -22


@pytest.mark.parametrize("shape", [(1024, 1024, 256), (1024, 4096, 256), (100, 300, 13)])
def test_3xtf32_keeps_reference_precision_and_argmax(shape):
    A, B, m = _problem(*shape, seed=11)
    S64 = A.astype(np.float64) @ B.astype(np.float64).T
    At, Bt, mt = torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(m)
    S3 = sim_3xtf32(At, Bt)
    assert float(np.abs(S3.numpy() - S64).max()) <= 1e-6
    # one TF32 pass is what the split is for: it misses the tolerance the
    # kernel is held to (1e-5) by an order of magnitude
    S1 = tf32_rna(At) @ tf32_rna(Bt).T
    assert float(np.abs(S1.numpy() - S64).max()) > 1e-5
    _, _, ref_idx = TB.row_top2_reference(At, Bt, mt)
    idx = torch.argmax(torch.where(mt[None, :], S3, -1e9), 1)
    assert torch.equal(idx.to(torch.int32), ref_idx)
