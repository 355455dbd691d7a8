"""The port's RG-LRU scan entry point on the CPU (its plain version,
`ref.rglru_scan_ref`) against the reference's `rg_ref.rglru_scan_ref` and
its Pallas kernel `rg_ops.rglru_scan` in interpret mode, on the shapes of
`tests/test_kernels.py` (the sweep, with padding in both dims, and the
long decay), with the same inputs made by numpy; and the model's plain
log-depth scan `models.rglru._lru_scan` against the reference's
associative scan.  Tolerance 1e-5 relative, the reference's bar (fp32
throughout; the scans sum in other orders).  Also the CUDA kernels' rule
and `kernel=` as a CPU call sees them, and the edits that
``tools/rglru_phases.py`` makes to the ring kernel's source."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru import ops as rg_ops
from repro.kernels.rglru import ref as rg_ref
from repro.models import rglru as JR
from repro_torch.kernels.rglru import ops as pt_ops
from repro_torch.kernels.rglru import ref as pt_ref
from repro_torch.models import rglru as TR


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _inputs(seed, B, S, R):
    """a in [0.79, 0.99] (a sigmoid scaled as the reference's test), b
    normal * 0.1."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, R)))) * 0.2
         + 0.79).astype(np.float32)
    b = (rng.standard_normal((B, S, R)) * 0.1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,R,chunk,block_r", [
    (1, 128, 128, 64, 128),
    (2, 300, 192, 128, 128),     # padding both dims in the reference
    (2, 64, 512, 64, 256),
])
def test_rglru_sweep(B, S, R, chunk, block_r):
    a, b = _inputs(R + S, B, S, R)
    before = pt_ops.rglru_scan.launches
    got = pt_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                            chunk=chunk, block_r=block_r)
    assert pt_ops.rglru_scan.launches == before      # CPU: no launch
    assert got.shape == (B, S, R) and got.dtype == torch.float32
    want = rg_ops.rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                             block_r=block_r)
    assert _err(got.numpy(), want) < 1e-5
    ref = pt_ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert _err(ref.numpy(), rg_ref.rglru_scan_ref(jnp.asarray(a),
                                                   jnp.asarray(b))) < 1e-5


def test_rglru_long_decay_stability():
    """Long sequences with a ~ 1 must not blow up."""
    B, S, R = 1, 2048, 128
    a = np.full((B, S, R), 0.999, np.float32)
    b = np.full((B, S, R), 0.01, np.float32)
    got = pt_ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = rg_ops.rglru_scan(jnp.asarray(a), jnp.asarray(b))
    assert _err(got.numpy(), want) < 1e-5
    assert _err(got.numpy(), rg_ref.rglru_scan_ref(jnp.asarray(a),
                                                   jnp.asarray(b))) < 1e-5
    assert bool(torch.isfinite(got).all())


def test_plain_version_rounds_each_step_once():
    """The reference's compiled recurrence is one fused multiply-add a
    step: at a constant a = 0.999, rounding the product and the sum apart
    drifts past the 1e-5 bar within 2,048 steps, and the plain version,
    rounding once, equals the reference bit for bit."""
    a = np.full((1, 2048, 8), 0.999, np.float32)
    b = np.full((1, 2048, 8), 0.01, np.float32)
    want = np.asarray(rg_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    h, apart = torch.zeros(1, 8), []
    for t in range(a.shape[1]):
        h = ta[:, t] * h + tb[:, t]
        apart.append(h)
    assert _err(torch.stack(apart, 1).numpy(), want) > 1e-5
    assert np.array_equal(pt_ref.rglru_scan_ref(ta, tb).numpy(), want)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_model_lru_scan_matches_the_reference(S, with_h0):
    a, b = _inputs(S, 2, S, 48)
    h0 = np.random.default_rng(9).standard_normal((2, 48)).astype(np.float32)
    want = JR._lru_scan(jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(h0) if with_h0 else None)
    got = TR._lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(h0) if with_h0 else None)
    assert _err(got.numpy(), want) < 1e-5


def test_rglru_scan_rejects_what_it_does_not_take():
    a, b = (torch.from_numpy(x) for x in _inputs(0, 1, 8, 16))
    with pytest.raises(ValueError, match="positive"):
        pt_ops.rglru_scan(a, b, chunk=0)
    with pytest.raises(ValueError, match="device"):
        pt_ops.rglru_scan(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        pt_ops.rglru_scan(a.to("meta"), b)


def test_rglru_kernel_rule_is_the_ring():
    """Every fp32 CUDA call runs the ring kernel: no size threshold, no
    knob; the direct kernel runs only when a call names it."""
    assert pt_ops.kernel_for() == "ring"
    assert pt_ops.KERNELS == ("ring", "direct")
    assert set(pt_ops.rglru_scan.launches_by_kernel) == set(pt_ops.KERNELS)
    assert [p.name for p in pt_ops.SOURCES] == ["rglru.cu", "rglru_ring.cu"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_rglru_scan_refuses_an_unknown_kernel(device):
    a, b = (torch.from_numpy(x).to(device) for x in _inputs(0, 1, 8, 16))
    with pytest.raises(ValueError, match="kernel must be one of"):
        pt_ops.rglru_scan(a, b, kernel="chunked")


@pytest.mark.parametrize("kernel", [None, "ring", "direct"])
def test_rglru_scan_cpu_call_checks_kernel_and_launches_nothing(kernel):
    """A CPU call takes `kernel=` as a CUDA call does, then runs the plain
    version: the same result whichever kernel it names, and no launch."""
    a, b = (torch.from_numpy(x) for x in _inputs(5, 2, 37, 100))
    before = pt_ops.rglru_scan.launches
    by_kernel = dict(pt_ops.rglru_scan.launches_by_kernel)
    got = pt_ops.rglru_scan(a, b, kernel=kernel)
    assert pt_ops.rglru_scan.launches == before
    assert pt_ops.rglru_scan.launches_by_kernel == by_kernel
    assert torch.equal(got, pt_ref.rglru_scan_ref(a, b))


def _load_tool(name):
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_PHASES = _load_tool("rglru_phases")


@pytest.mark.parametrize("T,K,copies", [(32, 2, True), (64, 8, True),
                                        (16, 4, False)])
def test_rglru_phases_edits_match_kernel_source(T, K, copies):
    """``tools/rglru_phases.py`` sets the ring kernel's stage length and
    depth and takes out its copies by the exact text of its source: each
    edited text is there once, and the variant holds the new values."""
    source = pt_ops.SOURCES[1].read_text()
    assert (_PHASES.knob(source, "T"), _PHASES.knob(source, "K")) == (16, 4)
    out = _PHASES.variant(source, T, K, copies)
    assert (_PHASES.knob(out, "T"), _PHASES.knob(out, "K")) == (T, K)
    assert source.count(_PHASES.COPIES) == 1
    assert (_PHASES.NO_COPIES in out) == (not copies)
    assert out.count("cp_async16(sa") == source.count("cp_async16(sa") == 1


def test_rglru_phases_bytes_in_flight():
    """At the served shape and the source's T 16, K 4: 320 blocks, all
    resident (3 an SM at most), 3 stages of 4 KB in flight a block; at T
    64, K 8 (128 KB a block) one block an SM."""
    resident, flight = _PHASES.in_flight(16, 4, 4, 2560)
    assert resident == 3
    assert flight == pytest.approx(3 * 4096 * 320 / 132, rel=1e-12)
    assert _PHASES.in_flight(64, 8, 4, 2560) == (1, 7 * 16384)
