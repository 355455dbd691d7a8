"""Tests of the port that need the card (marker `cuda`; they skip where
`torch.cuda.is_available()` is false, since a CUDA kernel has no CPU mode):
the netsim kernels and the simulator, the flash-attention, SSD scan and
RG-LRU scan kernels (the ring kernel bit for bit against the direct one;
each refusing autograd), the served LMs and the training path.

The file imports neither jax nor the reference package, so it runs on the
machine with the card, where JAX is not installed (`tests/conftest.py`
imports jax, hence `--noconftest`):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import topology as T
from repro_torch.core import traffic
from repro_torch.core.simulator import SimConfig, Simulator
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.netsim import (cycle_core, cycle_core_ref, grant,
                                       grant_ref)
from repro_torch.kernels.netsim import ops as netsim_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru import rglru_scan_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_ref
from repro_torch.launch.serve import draw_batch, generate
from repro_torch.models import transformer as TF

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _random_inputs(rng, B, N, E, device):
    cols = [rng.integers(-1, E, (B, N)).astype(np.int32),
            rng.integers(0, 4, (B, N)).astype(np.int32),
            rng.random((B, N)) < 0.8,
            rng.integers(0, 10, (B, N)).astype(np.int32),
            rng.random((B, N)) < 0.2,
            (rng.integers(0, 3, (B, E))
             * (rng.random((B, E)) < 0.3)).astype(np.int32),
            rng.random((B, E)) < 0.9]
    return [torch.as_tensor(c).to(device) for c in cols]


NETSIM_KERNELS = ("coop", "three_pass")
# shapes for both netsim kernels: one row and channel, ragged N, N % 4 == 0
# (the coop kernel's vector path), one channel for every row (ties), one
# lane of the radix-32 network's channels
NETSIM_SHAPES = [(1, 1, 1), (1, 1000, 301), (4, 20011, 1029),
                 (4, 20012, 1029), (1, 5000, 1), (4, 8000, 241280)]


@pytest.mark.parametrize("B,N,E", NETSIM_SHAPES)
@pytest.mark.parametrize("itime_lo", [0, 2**31 - 8])
@pytest.mark.parametrize("kernel", NETSIM_KERNELS)
def test_grant_kernel_matches_plain_version(cuda, B, N, E, itime_lo, kernel):
    """Bit for bit, each kernel forced, with stranded rows (out = -1), age
    ties, busy and dead channels, ages near 2^31, a shared alive mask."""
    args = _random_inputs(np.random.default_rng(N), B, N, E, cuda)
    args[1] += itime_lo
    before = grant.launches
    before_kernel = grant.launches_by_kernel[kernel]
    got = grant(*args, buf_pkts=8, kernel=kernel)
    torch.cuda.synchronize()
    assert grant.launches == before + 1
    assert grant.launches_by_kernel[kernel] == before_kernel + 1
    want = grant_ref(*args, buf_pkts=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # one lane equals the same lane run alone, shared channel masks too
    alive = args[6][:1].expand(B, E)
    got = grant(*args[:6], alive, buf_pkts=8, kernel=kernel)
    assert all(torch.equal(a, b) for a, b in
               zip(got, grant_ref(*args[:6], alive, buf_pkts=8)))
    for b in range(B):
        one = grant(*(x[b] for x in args[:6]), alive[b], buf_pkts=8,
                    kernel=kernel)
        assert torch.equal(one[0], got[0][b]) and torch.equal(one[1],
                                                              got[1][b])


def test_grant_coop_scratch_carries_over_calls(cuda):
    """The coop kernel keeps its table between calls (two halves, the
    call count on the device): calls on fresh inputs, on two shapes in
    turn and on a second stream each equal the plain version."""
    rng = np.random.default_rng(9)
    side = torch.cuda.Stream()
    for i in range(6):
        B, N, E = (4, 2000, 301) if i % 2 else (2, 3000, 77)
        args = _random_inputs(rng, B, N, E, cuda)
        want = grant_ref(*args, buf_pkts=8)
        with torch.cuda.stream(side if i >= 4 else
                               torch.cuda.current_stream()):
            got = grant(*args, buf_pkts=8, kernel="coop")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_three_pass_lane_limit(cuda):
    """More lanes than a grid's y dimension: the three-pass kernel
    refuses, the coop kernel (the rule's pick) takes them."""
    B = netsim_ops.MAX_LANES + 1
    args = _random_inputs(np.random.default_rng(2), B, 4, 1, cuda)
    assert netsim_ops.kernel_for() == "coop"
    with pytest.raises(ValueError, match="lanes"):
        grant(*args, buf_pkts=8, kernel="three_pass")
    got = grant(*args, buf_pkts=8)
    assert all(torch.equal(a, b) for a, b in
               zip(got, grant_ref(*args, buf_pkts=8)))


def test_simulator_on_card_equals_cpu(cuda):
    net = T.build_switchless(
        T.SwitchlessParams(a=2, b=2, m=2, n=4, noc=2, g=3), "small")
    cfg = SimConfig(warmup=30, measure=120, vc_mode="updown",
                    route_mode="ugal")
    grids = [Simulator(net, cfg, traffic.uniform(net), device=d)
             .sweep_grid([0.3, 1.2], seeds=(0, 1)) for d in (cuda, "cpu")]
    a, b = ([dataclasses.asdict(r) for r in g.flat()] for g in grids)
    assert a == b


def _random_cycle_inputs(rng, B, N, E, itime_lo, explicit_prio, device):
    out = rng.integers(-1, E, (B, N)).astype(np.int32)
    itime = rng.integers(itime_lo, itime_lo + 6, (B, N)).astype(np.int32)
    ok = rng.random((B, N)) < 0.7
    ch_ok = rng.random((B, E)) < 0.8
    r2 = 1 << (4 * N - 1).bit_length()
    prio = (np.stack([rng.permutation(r2)[:N] for _ in range(B)])
            .astype(np.int32) if explicit_prio else None)
    t = lambda x: None if x is None else torch.as_tensor(x).to(device)
    return [t(x) for x in (out, itime, ok, ch_ok)], t(prio), r2


@pytest.mark.parametrize("B,N,E", NETSIM_SHAPES)
@pytest.mark.parametrize("explicit_prio", [False, True])
@pytest.mark.parametrize("itime_lo", [0, 2**31 - 8])
@pytest.mark.parametrize("kernel", NETSIM_KERNELS)
def test_cycle_core_kernel_matches_plain_version(cuda, B, N, E,
                                                 explicit_prio, itime_lo,
                                                 kernel):
    """Bit for bit, each kernel forced, with stranded ok rows (out = -1),
    ties, masked channels, an explicit non-iota prio (the three-pass
    kernel's alone: the coop kernel refuses it) and ages where the
    reference's int32 key would overflow."""
    rng = np.random.default_rng(N + itime_lo % 97)
    args, prio, r2 = _random_cycle_inputs(rng, B, N, E, itime_lo,
                                          explicit_prio, cuda)
    if kernel == "coop" and explicit_prio:
        with pytest.raises(ValueError, match="row-index priority"):
            cycle_core(*args, r2=r2, prio=prio, kernel=kernel)
        return
    before = cycle_core.launches
    before_kernel = cycle_core.launches_by_kernel[kernel]
    got = cycle_core(*args, r2=r2, prio=prio, kernel=kernel)
    torch.cuda.synchronize()
    assert cycle_core.launches == before + 1
    assert cycle_core.launches_by_kernel[kernel] == before_kernel + 1
    want = cycle_core_ref(*args, r2=r2, prio=prio)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # one lane equals the same lane run alone, a shared channel mask too
    ch_ok = args[3][:1].expand(B, E)
    got = cycle_core(*args[:3], ch_ok, r2=r2, prio=prio, kernel=kernel)
    assert all(torch.equal(a, b) for a, b in zip(
        got, cycle_core_ref(*args[:3], ch_ok, r2=r2, prio=prio)))
    for b in range(B):
        one = cycle_core(*(x[b] for x in args[:3]), ch_ok[b], r2=r2,
                         prio=None if prio is None else prio[b],
                         kernel=kernel)
        assert all(torch.equal(o, g[b]) for o, g in zip(one, got))


@pytest.mark.parametrize("B,N,E", [
    (4, 204672, 30176),     # the fused step's shape
    (1, 1200000, 1029),     # more quads than two a thread: the loop turns
    (2, 8001, 1029),        # N % 4 != 0: plain loads
])
def test_cycle_core_coop_shapes(cuda, B, N, E):
    """The coop kernel's paths, bit for bit."""
    args, _, r2 = _random_cycle_inputs(np.random.default_rng(N), B, N, E, 0,
                                       False, cuda)
    got = cycle_core(*args, r2=r2, kernel="coop")
    want = cycle_core_ref(*args, r2=r2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("impl", ["fused", "compact"])
def test_fast_steps_on_card_equal_cpu(cuda, impl):
    net = T.build_switchless(
        T.SwitchlessParams(a=2, b=2, m=2, n=4, noc=2, g=3), "small")
    cfg = SimConfig(warmup=30, measure=120, vc_mode="updown",
                    route_mode="ugal", step_impl=impl)
    grids = [Simulator(net, cfg, traffic.uniform(net), device=d)
             .sweep_grid([0.3, 1.2], seeds=(0, 1)) for d in (cuda, "cpu")]
    a, b = ([dataclasses.asdict(r) for r in g.flat()] for g in grids)
    assert a == b


def test_compact_escalation_on_card_equals_cpu(cuda):
    """A compact run pinned below the live peak escalates on the card
    exactly as on the CPU."""
    net = T.build_switchless(
        T.SwitchlessParams(a=2, b=2, m=2, n=4, noc=2, g=3), "small")
    cfg = SimConfig(warmup=30, measure=120, step_impl="compact")
    lanes = [(r, s, None) for r in (0.3, 1.2) for s in (0, 1)]
    runs = [Simulator(net, cfg, traffic.uniform(net), device=d)._batched
            .run_lanes_async(lanes, capacity=40).finish()
            for d in (cuda, "cpu")]
    assert runs[0].escalations == runs[1].escalations >= 1
    a, b = ([dataclasses.asdict(r) for r in run.results] for run in runs)
    assert a == b


FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-6))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,kw", [
    (1, 128, 128, 2, 2, 64, dict(causal=True)),
    (2, 192, 320, 4, 1, 80, dict(causal=True)),      # MQA, ragged, hd 80
    (1, 64, 64, 10, 1, 256, dict(causal=True)),      # hd 256: 139 KB smem
    (2, 100, 100, 4, 2, 16, dict(causal=True)),      # smoke head_dim
    (2, 256, 256, 4, 2, 64, dict(causal=True, window=32)),
    (1, 128, 200, 2, 2, 64, dict(causal=False)),     # ragged non-causal
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda, B, Sq, Sk, H, KV,
                                                      hd, kw, dtype):
    g = torch.Generator(device=cuda).manual_seed(Sq * hd + Sk)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kernel = fa_ops.kernel_for(dtype, hd)
    before = fa_ops.flash_attention.launches
    before_kernel = fa_ops.flash_attention.launches_by_kernel[kernel]
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert (fa_ops.flash_attention.launches_by_kernel[kernel]
            == before_kernel + 1)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel(got, attention_ref(q, k, v, **kw)) < FA_TOL[dtype]


def _row_rel(got, want):
    """The largest over output rows of each row's largest |got - want|
    over that row's largest |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return float((err / want.float().abs().amax(-1).clamp(min=1e-6)).max())


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,kw", [
    (1, 128, 128, 2, 2, 64, dict(causal=True)),
    (2, 256, 256, 6, 2, 128, dict(causal=True)),      # GQA, 3 groups
    (1, 192, 192, 4, 1, 256, dict(causal=True)),      # MQA, hd 256
    (2, 200, 333, 6, 2, 128, dict(causal=True)),      # Sq, Sk off the tile
    (2, 200, 333, 4, 1, 64, dict(causal=True)),
    (1, 333, 333, 4, 1, 256, dict(causal=True, window=100)),
    (1, 300, 300, 6, 2, 128, dict(causal=True, window=100)),
    (1, 4096, 4096, 2, 1, 256, dict(causal=True, window=2048)),
    (2, 200, 333, 6, 2, 128, dict(causal=False)),     # non-causal Sq != Sk
    (2, 333, 200, 4, 1, 256, dict(causal=False)),
    (1, 333, 200, 2, 2, 64, dict(causal=False)),
])
def test_flash_attention_wgmma_kernel_matches_plain_version(cuda, B, Sq, Sk,
                                                            H, KV, hd, kw):
    """bf16 at head_dim 64, 128 and 256 runs the tensor-core kernel (and
    not the FMA kernel), held per output row to the bf16 bar."""
    g = torch.Generator(device=cuda).manual_seed(Sq * hd + Sk + H)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    before = dict(fa_ops.flash_attention.launches_by_kernel)
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = fa_ops.flash_attention.launches_by_kernel
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["fma"] == before["fma"]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _row_rel(got, attention_ref(q, k, v, **kw)) < FA_TOL[torch.bfloat16]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,kw", [
    (2, 200, 200, 4, 2, 96, dict(causal=True)),       # phi-3-vision's hd
    (1, 256, 333, 6, 2, 96, dict(causal=False)),
    (1, 300, 300, 4, 1, 96, dict(causal=True, window=100)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_padded_head_dim_matches_plain_version(
        cuda, B, Sq, Sk, H, KV, hd, kw, dtype):
    """hd 96 runs zero-padded to 128 on the kernel the rule names (bf16:
    the tensor-core kernel, fp32: the FMA kernel), held per output row to
    `attention_ref` at the usual bars."""
    g = torch.Generator(device=cuda).manual_seed(Sq * hd + Sk + H)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kernel = fa_ops.kernel_for(dtype, hd)
    before = dict(fa_ops.flash_attention.launches_by_kernel)
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = fa_ops.flash_attention.launches_by_kernel
    assert {name: after[name] - before[name] for name in after} == {
        name: int(name == kernel) for name in after}
    assert got.dtype == dtype and got.shape == q.shape
    assert _row_rel(got, attention_ref(q, k, v, **kw)) < FA_TOL[dtype]


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 320), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="float32"):
        fa_ops.flash_attention(q.half(), q.half(), q.half())


def _ssd_inputs(g, B, S, H, P, N, dtype, device):
    x = (torch.randn((B, S, H, P), generator=g, device=device) * 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=device))
    A = torch.randn((H,), generator=g, device=device).abs() + 0.1
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=device) * 0.3
              for _ in range(2))
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.parametrize("B,S,H,P,N", [
    (1, 64, 2, 16, 16), (2, 100, 2, 64, 32), (3, 192, 2, 32, 16),
    (1, 160, 2, 32, 16), (2, 37, 3, 16, 16), (1, 300, 4, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(cuda, B, S, H, P, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(S * P + N)
    args = _ssd_inputs(g, B, S, H, P, N, dtype, cuda)
    kernel = ssd_ops.kernel_for(dtype, P, N)
    before = ssd_ops.ssd_scan.launches
    before_kernel = ssd_ops.ssd_scan.launches_by_kernel[kernel]
    y, state = ssd_ops.ssd_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == before + 1
    assert ssd_ops.ssd_scan.launches_by_kernel[kernel] == before_kernel + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    want_y, want_s = ssd_ref(*args)
    assert _rel(y, want_y) < (1e-4 if dtype == torch.float32 else 2e-2)
    assert _rel(state, want_s) < 1e-4


def _conv_views(x, Bm, Cm, lead=0):
    """x, Bm, Cm as the views of one [B, S, lead + H P + 2 N] buffer that
    `ssm_apply` passes (its conv output), `lead` elements in."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    buf = torch.cat([x.new_zeros((B, S, lead)), x.reshape(B, S, H * P), Bm,
                     Cm], -1)
    di = lead + H * P
    return (buf[..., lead:di].reshape(B, S, H, P), buf[..., di:di + N],
            buf[..., di + N:])


@pytest.mark.parametrize("B,S,H,P,N,layout", [
    (1, 2048, 48, 64, 128, "contiguous"),    # mamba2-780m's prefill, B 1
    (1, 2048, 48, 64, 128, "views"),
    (2, 300, 4, 64, 128, "views"),           # ragged S
    (2, 37, 3, 32, 64, "views"),
    (1, 100, 2, 16, 48, "views"),            # N off the kernel's 64 columns
    (2, 130, 2, 64, 256, "views"),
    (1, 200, 3, 64, 128, "misaligned views"),
])
def test_ssd_scan_wgmma_kernel_matches_plain_version(cuda, B, S, H, P, N,
                                                     layout):
    """bf16 runs the tensor-core kernel (and not the FMA kernel), on
    contiguous tensors and on the strided views of the conv output that
    `ssm_apply` passes (read in place; copied only when a view is not
    16-byte aligned), held per output row to the bf16 bar and the state
    to 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(S + P + N + H)
    x, dt, A, Bm, Cm = _ssd_inputs(g, B, S, H, P, N, torch.bfloat16, cuda)
    if layout != "contiguous":
        x, Bm, Cm = _conv_views(x, Bm, Cm, lead=layout.count("misaligned"))
        assert not x.is_contiguous() and not Bm.is_contiguous()
    before = dict(ssd_ops.ssd_scan.launches_by_kernel)
    y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, return_state=True)
    torch.cuda.synchronize()
    after = ssd_ops.ssd_scan.launches_by_kernel
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["fma"] == before["fma"]
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    want_y, want_s = ssd_ref(x, dt, A, Bm, Cm)
    assert _row_rel(y, want_y) < 2e-2
    assert _rel(state, want_s) < 1e-4


def test_ssd_scan_kernel_rejects_what_it_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, Bm, Cm = _ssd_inputs(g, 1, 8, 2, 24, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm)
    x, dt, A, Bm, Cm = _ssd_inputs(g, 1, 8, 2, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_scan(x, dt.half(), A, Bm, Cm)


@pytest.mark.parametrize("B,S,R", [(1, 128, 128), (2, 300, 192),
                                   (2, 64, 512), (1, 37, 2560)])
def test_rglru_kernel_matches_plain_version(cuda, B, S, R):
    g = torch.Generator(device=cuda).manual_seed(R + S)
    a = torch.sigmoid(torch.randn((B, S, R), generator=g, device=cuda)) \
        * 0.2 + 0.79
    b = torch.randn((B, S, R), generator=g, device=cuda) * 0.1
    before = rglru_ops.rglru_scan.launches
    got = rglru_ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_ops.rglru_scan.launches == before + 1
    assert _rel(got, rglru_scan_ref(a, b)) < 1e-5
    a = torch.full((1, 2048, 128), 0.999, device=cuda)
    b = torch.full((1, 2048, 128), 0.01, device=cuda)
    assert _rel(rglru_ops.rglru_scan(a, b), rglru_scan_ref(a, b)) < 1e-5


# (B, S, R, a and b as constants or None, the base offset in elements): the
# cases of chip_smoke.py phase 8 — the reference's sweep, the long decay, R
# not a multiple of 32, S not a multiple of the ring's 16-step stage, B 1
# and 4, a base off 16 bytes (the 4-byte copies) and the served shape
RGLRU_CASES = [(1, 128, 128, None, 0), (2, 300, 192, None, 0),
               (2, 64, 512, None, 0), (1, 2048, 128, (0.999, 0.01), 0),
               (4, 1, 37, None, 0), (1, 37, 100, None, 0),
               (4, 300, 37, None, 0), (1, 300, 100, None, 0),
               (4, 37, 2560, None, 0), (2, 64, 512, None, 1),
               (4, 4096, 2560, None, 0)]


@pytest.mark.parametrize("B,S,R,const,offset", RGLRU_CASES)
def test_rglru_ring_kernel_equals_direct_kernel(cuda, B, S, R, const,
                                                offset):
    """The rule's ring kernel bit for bit against the direct kernel on the
    same inputs (one fmaf a step from zero in both), within 1e-5 of the
    plain version, each launch counted on its own kernel."""
    g = torch.Generator(device=cuda).manual_seed(B + S + R)
    n = B * S * R
    if const is None:
        a = torch.sigmoid(torch.randn(n + offset, generator=g, device=cuda)) \
            * 0.2 + 0.79
        b = torch.randn(n + offset, generator=g, device=cuda) * 0.1
    else:
        a = torch.full((n + offset,), const[0], device=cuda)
        b = torch.full((n + offset,), const[1], device=cuda)
    a, b = (x[offset:].view(B, S, R) for x in (a, b))
    assert a.data_ptr() % 16 == 4 * offset
    before = dict(rglru_ops.rglru_scan.launches_by_kernel)
    got = rglru_ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    after = dict(rglru_ops.rglru_scan.launches_by_kernel)
    assert after == dict(before, ring=before["ring"] + 1)
    want = rglru_ops.rglru_scan(a, b, kernel="direct")
    torch.cuda.synchronize()
    assert rglru_ops.rglru_scan.launches_by_kernel == dict(
        after, direct=after["direct"] + 1)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, rglru_scan_ref(a, b)) < 1e-5


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "recurrentgemma-2b", "deepseek-moe-16b",
                                  "phi-3-vision-4.2b", "seamless-m4t-medium"])
def test_serve_smoke_model_on_card_equals_cpu(cuda, arch):
    """The same fp32 weights and inputs (phi-3-vision's prefix rows,
    seamless's source frames) on both devices: equal greedy tokens,
    prefill logits within 1e-4 relative (the card sums in other
    orders)."""
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32")
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = draw_batch(cfg, 2, 40, seed=2)
    outs = [generate(m, cfg, batch, 8, prefill_impl="kernel",
                     device=d)[0].cpu() for m, d in ((card, cuda),
                                                     (cpu, "cpu"))]
    assert torch.equal(outs[0], outs[1])
    logits = []
    with torch.inference_mode():
        for m, d in ((card, cuda), (cpu, "cpu")):
            cache = TF.init_cache(cfg, 2, 40 + cfg.num_prefix, device=d)
            logits.append(TF.forward(m, cfg, {
                k: torch.as_tensor(v).to(d) for k, v in batch.items()},
                "prefill", cache=cache, attn_impl="kernel")[0].cpu())
    assert _rel(logits[0], logits[1]) < 1e-4


def test_lm_kernels_refuse_autograd(cuda):
    """Forward-only kernels: a call autograd would record raises (its
    output would carry no grad_fn); under no_grad it runs."""
    g = torch.Generator(device=cuda).manual_seed(3)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    calls = [(fa_ops.flash_attention, [t(1, 64, 2, 64, dtype=torch.bfloat16)
                                       for _ in range(3)]),
             (ssd_ops.ssd_scan, [t(1, 64, 2, 16), t(1, 64, 2).abs(),
                                 t(2).abs(), t(1, 64, 16), t(1, 64, 16)]),
             (rglru_ops.rglru_scan, [t(1, 64, 32).sigmoid(), t(1, 64, 32)])]
    for fn, args in calls:
        args[-1].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
        with torch.no_grad():
            assert bool(torch.isfinite(fn(*args)).all())


@pytest.mark.parametrize("arch,dispatch", [("minicpm-2b", "bf16"),
                                           ("deepseek-moe-16b", "int8")])
def test_train_steps_on_card_equal_cpu(cuda, arch, dispatch):
    """Three fp32 train steps (chunked attention, remat, microbatch 2) from
    the same weights: metrics at 1e-5 relative, every parameter element
    within 1e-5 but at most 1e-3 of them (rounding noise below Adam's eps
    moves an element by up to lr a step), those within Adam's largest
    move (as `chip_smoke.py` phase 15)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.runtime.trainer import TrainSetup, make_train_step
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    setup = TrainSetup(model=cfg, opt=OptConfig(
        lr=1e-3, warmup_steps=1, total_steps=3, weight_decay=0.1),
        attn_impl="chunked", remat=True, microbatch=2)
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    runs = []
    for model in (copy.deepcopy(cpu).to(cuda), cpu):
        step, opt = make_train_step(setup), init_opt_state(model)
        data = SyntheticTokens(cfg.vocab_size, 4, 64, seed=3)
        hist = []
        for _ in range(3):
            model, opt, m = step(model, opt, next(data))
            hist.append({k: float(v) for k, v in m.items()})
        runs.append((model, hist))
    (card, chist), (cpu, phist) = runs
    for a, b in zip(chist, phist):
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), k
    d = torch.cat([(p.detach().cpu() - q.detach()).abs().reshape(-1)
                   for p, q in zip(card.parameters(), cpu.parameters())])
    assert float((d > 1e-5).float().mean()) <= 1e-3
    assert float(d.max()) <= 2 * sum(h["lr"] for h in phist)


def test_bf16_training_checkpoint_round_trips_on_card(cuda, tmp_path):
    """A bf16 trainer's snapshot restored after more steps: every param
    and optimizer leaf bit for bit."""
    from repro_torch.checkpoint.checkpointing import Checkpointer
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.runtime.trainer import Trainer, TrainSetup
    cfg = get_config("deepseek-moe-16b-smoke")
    tr = Trainer(TrainSetup(model=cfg, opt=OptConfig(lr=2e-3),
                            attn_impl="naive", remat=False),
                 SyntheticTokens(cfg.vocab_size, 4, 32, seed=3),
                 checkpointer=Checkpointer(str(tmp_path)), device=cuda)
    tr.run(3)
    tr.save()
    saved = [t.detach().clone() for t in tr.model.parameters()]
    saved += [t.clone() for k in ("master", "m", "v")
              for t in tr.opt_state[k].values()]
    tr.run(2)
    assert tr.restore() == 3
    now = [t.detach() for t in tr.model.parameters()]
    now += [t for k in ("master", "m", "v") for t in tr.opt_state[k].values()]
    assert any(t.dtype == torch.bfloat16 for t in now)
    for a, b in zip(now, saved):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
