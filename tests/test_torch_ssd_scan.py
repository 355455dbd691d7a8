"""The port's SSD scan entry point on the CPU (its plain version,
`ref.ssd_ref`) against the reference's `sd_ref.ssd_ref` and its Pallas
kernel `sd_ops.ssd_scan` in interpret mode, on the shapes of
`tests/test_kernels.py` (the property sweep and the chunk-invariance
case), with the same inputs made by numpy.  Tolerances: the two
sequential oracles at 1e-5 relative (y and the final state), the kernel
entry points at 1e-4 as there (the Pallas kernel sums chunk-wise), bf16
inputs at 2e-2 (y is rounded to bf16 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as sd_ops
from repro.kernels.ssd_scan import ref as sd_ref
from repro_torch.kernels.ssd_scan import ops as pt_ops
from repro_torch.kernels.ssd_scan import ref as pt_ref


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _np(x):
    return x.float().numpy()


def _inputs(seed, B, S, H, P, N, dtype="float32"):
    """x, dt (post-softplus), A (positive), Bm, Cm as in the reference's
    tests, in both frameworks; x, Bm, Cm rounded once to `dtype`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32) * 0.5
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (np.abs(rng.standard_normal(H)) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32) * 0.3
    Cm = rng.standard_normal((B, S, N), dtype=np.float32) * 0.3
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    low = (0, 3, 4)                     # x, Bm, Cm in `dtype`
    arrs = (x, dt, A, Bm, Cm)
    jx = [jnp.asarray(a, jdt if i in low else jnp.float32)
          for i, a in enumerate(arrs)]
    tx = [torch.from_numpy(a).to(tdt if i in low else torch.float32)
          for i, a in enumerate(arrs)]
    return jx, tx


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 64, 2, 16, 16), (2, 100, 2, 64, 32), (3, 37, 3, 32, 16)])
def test_ssd_ref_equals_the_reference(B, S, H, P, N):
    jx, tx = _inputs(S * P + N, B, S, H, P, N)
    want_y, want_s = sd_ref.ssd_ref(*jx)
    got_y, got_s = pt_ref.ssd_ref(*tx)
    assert got_y.dtype == torch.float32 and got_s.shape == (B, H, P, N)
    assert _err(_np(got_y), want_y) < 1e-5
    assert _err(_np(got_s), want_s) < 1e-5


# the space of test_kernels.py's `test_ssd_property` (B 1..3, S in
# {64, 100, 192}, P in {16, 64}, N in {16, 32}, H = 2, chunk 32)
@pytest.mark.parametrize("B,S,P,N", [
    (1, 64, 16, 16), (2, 100, 64, 32), (3, 192, 16, 32), (1, 192, 64, 16),
    (2, 64, 64, 32), (3, 100, 16, 16)])
def test_ssd_scan_property(B, S, P, N):
    jx, tx = _inputs(S * P + N, B, S, 2, P, N)
    before = pt_ops.ssd_scan.launches
    y, state = pt_ops.ssd_scan(*tx, chunk=32, return_state=True)
    assert pt_ops.ssd_scan.launches == before       # CPU: no launch
    assert y.shape == tx[0].shape and y.dtype == torch.float32
    assert _err(_np(y), sd_ops.ssd_scan(*jx, chunk=32)) < 1e-4
    ref_y, ref_s = sd_ref.ssd_ref(*jx)
    assert _err(_np(y), ref_y) < 1e-4
    assert _err(_np(state), ref_s) < 1e-4
    assert torch.equal(pt_ops.ssd_scan(*tx, chunk=32), y)


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_ssd_scan_chunk_invariance(chunk):
    jx, tx = _inputs(3, 1, 160, 2, 32, 16)
    want = sd_ops.ssd_scan(*jx, chunk=chunk)
    got = pt_ops.ssd_scan(*tx, chunk=chunk)
    assert _err(_np(got), want) < 1e-4
    assert _err(_np(got), sd_ref.ssd_ref(*jx)[0]) < 1e-4


def test_ssd_scan_bf16_inputs():
    """bf16 x, B, C: y comes back in bf16, within one rounding of the
    reference's."""
    jx, tx = _inputs(5, 2, 96, 2, 16, 16, dtype="bfloat16")
    got, state = pt_ops.ssd_scan(*tx, return_state=True)
    want_y, want_s = sd_ref.ssd_ref(*jx)
    assert got.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _err(_np(got), want_y) < 2e-2
    assert _err(_np(got), sd_ops.ssd_scan(*jx, chunk=32)) < 2e-2
    assert _err(_np(state), want_s) < 1e-5


def test_ssd_scan_rejects_what_it_does_not_take():
    _, tx = _inputs(0, 1, 8, 2, 16, 16)
    with pytest.raises(ValueError, match="chunk"):
        pt_ops.ssd_scan(*tx, chunk=0)
    meta = [t.to("meta") for t in tx]
    with pytest.raises(ValueError, match="device"):
        pt_ops.ssd_scan(*meta)
    with pytest.raises(ValueError, match="several devices"):
        pt_ops.ssd_scan(*meta[:4], tx[4])
