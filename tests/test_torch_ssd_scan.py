"""The port's SSD scan entry point on the CPU (its plain version,
`ref.ssd_ref`) against the reference's `sd_ref.ssd_ref` and its Pallas
kernel `sd_ops.ssd_scan` in interpret mode, on the shapes of
`tests/test_kernels.py` (the property sweep and the chunk-invariance
case), with the same inputs made by numpy.  Tolerances: the two
sequential oracles at 1e-5 relative (y and the final state), the kernel
entry points at 1e-4 as there (the Pallas kernel sums chunk-wise), bf16
inputs at 2e-2 (y is rounded to bf16 on both sides)."""
import importlib.util
from pathlib import Path

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


def _row_err(a, b):
    """The largest over output rows (one (b, t, h) over P) of each row's
    largest |a - b| over that row's largest |b|: the bf16 bar of the
    kernels."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    err = np.abs(a - b).max(-1) / np.maximum(np.abs(b).max(-1), 1e-6)
    return float(err.max())


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 64, 2, 16, 16), (2, 100, 2, 64, 32), (3, 37, 3, 32, 16),
    (1, 300, 2, 64, 128)])
def test_ssd_chunk_ref_fp32_equals_the_reference(B, S, H, P, N):
    """The tensor-core kernel's decomposition in fp32, without its
    roundings, is the chunked form of the same recurrence: 1e-4 against
    the reference's oracle and its Pallas kernel."""
    jx, tx = _inputs(S + P + N, B, S, H, P, N)
    y, state = pt_ref.ssd_chunk_ref(*tx, chunk=64)
    want_y, want_s = sd_ref.ssd_ref(*jx)
    assert y.dtype == torch.float32 and state.shape == (B, H, P, N)
    assert _err(_np(y), want_y) < 1e-4
    assert _err(_np(state), want_s) < 1e-4
    assert _err(_np(y), sd_ops.ssd_scan(*jx, chunk=32)) < 1e-4


@pytest.mark.parametrize("S", [37, 100, 300])
def test_ssd_chunk_ref_bf16_roundings_ragged(S):
    """With the kernel's roundings (W in bf16; S_in and v as bf16 hi +
    lo) on bf16 inputs and a ragged S: y within 2e-2 per output row and
    the final state within 1e-4 of the reference's oracle, y also of its
    Pallas kernel."""
    jx, tx = _inputs(S, 2, S, 3, 64, 128, dtype="bfloat16")
    y, state = pt_ref.ssd_chunk_ref(*tx, chunk=64, rounding=True)
    want_y, want_s = sd_ref.ssd_ref(*jx)
    assert y.dtype == torch.bfloat16 and y.shape == tx[0].shape
    assert _row_err(_np(y), want_y) < 2e-2
    assert _err(_np(state), want_s) < 1e-4
    assert _row_err(_np(y), sd_ops.ssd_scan(*jx, chunk=64)) < 2e-2


@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_chunk_ref_chunk_invariance(chunk):
    """The decomposition does not depend on its chunk: fp32 without
    roundings within 1e-4 of the oracle, and with roundings on bf16
    inputs within the bf16 bars, at L = 64, 128, 256."""
    jx, tx = _inputs(4, 1, 320, 2, 32, 64)
    y, state = pt_ref.ssd_chunk_ref(*tx, chunk=chunk)
    want_y, want_s = sd_ref.ssd_ref(*jx)
    assert _err(_np(y), want_y) < 1e-4
    assert _err(_np(state), want_s) < 1e-4
    jb, tb = _inputs(4, 1, 320, 2, 32, 64, dtype="bfloat16")
    y, state = pt_ref.ssd_chunk_ref(*tb, chunk=chunk, rounding=True)
    want_y, want_s = sd_ref.ssd_ref(*jb)
    assert _row_err(_np(y), want_y) < 2e-2
    assert _err(_np(state), want_s) < 1e-4


def test_ssd_chunk_ref_served_shape_roundings():
    """mamba2-780m's sequence and head shape (S 2,048, P 64, N 128) with
    a few heads: the kernel's roundings hold both bars over 32 chunks of
    64, where one bf16 operand for v would not hold the state's."""
    jx, tx = _inputs(11, 1, 2048, 3, 64, 128, dtype="bfloat16")
    y, state = pt_ref.ssd_chunk_ref(*tx, chunk=64, rounding=True)
    want_y, want_s = sd_ref.ssd_ref(*jx)
    assert _row_err(_np(y), want_y) < 2e-2
    assert _err(_np(state), want_s) < 1e-4


@pytest.mark.parametrize("dtype,P,N,kernel", [
    (torch.bfloat16, 64, 128, "wgmma"), (torch.bfloat16, 16, 16, "wgmma"),
    (torch.bfloat16, 32, 256, "wgmma"), (torch.bfloat16, 64, 48, "wgmma"),
    (torch.bfloat16, 64, 100, "fma"), (torch.bfloat16, 16, 1, "fma"),
    (torch.float32, 64, 128, "fma"), (torch.float32, 16, 16, "fma"),
    (torch.bfloat16, 24, 128, "head_dim"), (torch.float32, 128, 64, "head_dim"),
    (torch.bfloat16, 64, 272, "d_state"), (torch.float32, 64, 0, "d_state"),
    (torch.float16, 64, 128, "float32"), (torch.float64, 64, 128, "float32"),
])
def test_ssd_scan_dispatch_rule(dtype, P, N, kernel):
    """The static (dtype, P, N) rule that picks a CUDA call's kernel: bf16
    with N a multiple of 16 on the tensor-core kernel, fp32 and other bf16
    N on the FMA kernel, P in (16, 32, 64) and N up to 256 for both;
    anything else raises (the value names the message)."""
    if kernel in ("wgmma", "fma"):
        assert pt_ops.kernel_for(dtype, P, N) == kernel
    else:
        with pytest.raises(ValueError, match=kernel):
            pt_ops.kernel_for(dtype, P, N)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_takes_the_conv_output_views(dtype):
    """`ssm_apply` passes x, B and C as strided views of one conv output
    [B, S, H P + 2 N]; the entry point takes them as they are and gives
    what it gives on contiguous copies."""
    _, tx = _inputs(6, 2, 70, 3, 32, 64, dtype=dtype)
    x, dt, A, Bm, Cm = tx
    B, S, H, P = x.shape
    buf = torch.cat([x.reshape(B, S, H * P), Bm, Cm], -1)
    di, N = H * P, Bm.shape[-1]
    views = (buf[..., :di].reshape(B, S, H, P), dt, A,
             buf[..., di:di + N], buf[..., di + N:])
    assert not views[0].is_contiguous() and not views[3].is_contiguous()
    got_y, got_s = pt_ops.ssd_scan(*views, return_state=True)
    want_y, want_s = pt_ops.ssd_scan(*(t.contiguous() for t in views),
                                     return_state=True)
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)


def _load_tool(name):
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_PHASES = _load_tool("ssd_phases")


@pytest.mark.parametrize("k", range(len(_PHASES.PHASES)))
def test_ssd_phases_mark_matches_kernel_source(k):
    """``tools/ssd_phases.py`` marks the tensor-core kernel's phases by
    the exact text of its source: each phase's text is there once, and
    the instrumented source holds one mark more for each."""
    source = pt_ops.SOURCES[1].read_text()
    name, where, text = _PHASES.PHASES[k]
    assert source.count(text) == 1
    mark = f"    SSD_PHASE({k})\n"
    out = _PHASES.instrumented(source)
    assert (text + mark if where == "after" else mark + text) in out
    assert all(source.count(a) == 1 for a in _PHASES.ANCHORS)
