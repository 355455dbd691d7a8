"""Parity of the port's `cycle_core` (`repro_torch.kernels.netsim`) with
the JAX reference's Pallas `cycle_core` (interpret mode) and with both
int32 forms of the reference fused step's `_grant`.

On the CPU `ops.cycle_core` runs the plain PyTorch version
`ref.cycle_core_ref`, whose 64-bit key ``(itime << 32) | prio`` must give
the reference's packed int32 key wherever that fits and its two-pass
age-then-priority form everywhere, including generation cycles up to
2^31 - 2 where ``itime * r2 + prio`` overflows int32.  Random tables
crowd few channels (age ties), leave channels without any eligible row,
mask channels off, and carry stranded (``out = -1``) rows.  The CUDA
kernel itself is held to `cycle_core_ref` on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.core.engine.fused import _grant as jax_grant
from repro.kernels.netsim import cycle_core as jax_cycle_core
from repro_torch.core.engine.fused import _grant
from repro_torch.kernels.netsim import cycle_core, cycle_core_ref
from repro_torch.kernels.netsim.ref import check_r2

torch.set_num_threads(1)


def _pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def _tables(rng, N, E, *, itime_hi=6, explicit_prio=False):
    """(out, itime, ok, ch_ok, prio or None, r2) as numpy, unbatched."""
    out = rng.integers(-1, E, N).astype(np.int32)
    itime = rng.integers(max(0, itime_hi - 6), itime_hi, N).astype(np.int32)
    ok = (rng.random(N) < 0.7) & (out >= 0)
    ch_ok = rng.random(E) < 0.8
    if explicit_prio:
        # non-iota, unique priorities spread below r2 (the compact step
        # feeds sorted global row ids; any unique set must work)
        r2 = _pow2(4 * N)
        prio = rng.permutation(r2)[:N].astype(np.int32)
    else:
        r2, prio = _pow2(N), None
    return out, itime, ok, ch_ok, prio, r2


def _port(fn, out, itime, ok, ch_ok, prio, r2):
    t = lambda x: None if x is None else torch.as_tensor(x)
    return [x.numpy() for x in fn(t(out), t(itime), t(ok), t(ch_ok), r2=r2,
                                  prio=t(prio))]


def _reference_win(ok, out, prio, won, wprio):
    """The pop mask implied by the winner table: row r pops iff it is ok
    and its channel granted exactly its priority."""
    N, E = out.shape[0], won.shape[0]
    prio = np.arange(N) if prio is None else prio
    oc = np.clip(out, 0, E - 1)
    return ok & (out >= 0) & won[oc] & (wprio[oc] == prio)


SHAPES = [(1, 1), (77, 5), (300, 37), (1024, 128), (2000, 301)]


@pytest.mark.parametrize("N,E", SHAPES)
@pytest.mark.parametrize("explicit_prio", [False, True])
def test_cycle_core_ref_matches_pallas_kernel(N, E, explicit_prio):
    rng = np.random.default_rng(N + 7 * E)
    out, itime, ok, ch_ok, prio, r2 = _tables(
        rng, N, E, itime_hi=900, explicit_prio=explicit_prio)
    want = jax_cycle_core(jnp.asarray(out), jnp.asarray(itime),
                          jnp.asarray(ok), jnp.asarray(ch_ok), r2=r2,
                          prio=None if prio is None else jnp.asarray(prio),
                          interpret=True)
    want = [np.asarray(x) for x in want]
    for fn in (cycle_core_ref, cycle_core):
        got = _port(fn, out, itime, ok, ch_ok, prio, r2)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and (a == b).all()


@pytest.mark.parametrize("N,E", SHAPES)
@pytest.mark.parametrize("explicit_prio", [False, True])
@pytest.mark.parametrize("itime_hi", [6, 2**31 - 1])
def test_cycle_core_ref_matches_both_grant_forms(N, E, explicit_prio,
                                                 itime_hi):
    """The combined int32 key where it fits (small itime), the two-pass
    form always — up to itime = 2^31 - 2, where the int32 key would
    overflow.  The port's own `_grant` equals the reference's too."""
    rng = np.random.default_rng(3 * N + E)
    out, itime, ok, ch_ok, prio, r2 = _tables(
        rng, N, E, itime_hi=itime_hi, explicit_prio=explicit_prio)
    p = np.arange(N, dtype=np.int32) if prio is None else prio
    forms = [False] if itime_hi > 2**20 else [False, True]
    got = _port(cycle_core_ref, out, itime, ok, ch_ok, prio, r2)
    for combined in forms:
        args = (ok, out, itime, p, ch_ok)
        won, wprio = (np.asarray(x) for x in jax_grant(
            *(jnp.asarray(a) for a in args), E, r2, combined))
        assert (got[0] == won).all() and (got[1] == wprio).all()
        assert (got[2] == _reference_win(ok, out, prio, won, wprio)).all()
        mine = _grant(*(torch.as_tensor(a)[None] for a in args), E, r2,
                      combined)
        assert (mine[0][0].numpy() == won).all()
        assert (mine[1][0].numpy() == wprio).all()
    if itime_hi > 2**20 and r2 > 1:
        assert (itime[ok].astype(np.int64) * r2 >= 2**31).any(), \
            "vacuous: no key would overflow int32"


def test_all_ineligible_and_masked_channels():
    """No ok row, or every channel masked off: nobody wins anywhere."""
    rng = np.random.default_rng(0)
    out, itime, ok, ch_ok, _, r2 = _tables(rng, 500, 40)
    for o, c in ((ok & False, ch_ok), (ok, ch_ok & False)):
        won, wprio, win = _port(cycle_core_ref, out, itime, o, c, None, r2)
        assert not won.any() and not win.any() and not wprio.any()


def test_stranded_rows_never_win():
    """An ok row whose channel is outside [0, E) is never granted (the
    engine never marks one ok; the kernel must not read out of range)."""
    out = torch.tensor([-1, -1, 0, 5], dtype=torch.int32)
    itime = torch.zeros(4, dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    won, wprio, win = cycle_core_ref(out, itime, ok,
                                     torch.ones(2, dtype=torch.bool), r2=4)
    assert win.tolist() == [False, False, True, False]
    assert won.tolist() == [True, False] and wprio.tolist() == [2, 0]


@pytest.mark.parametrize("explicit_prio", [False, True])
def test_lanes_equal_unbatched(explicit_prio):
    """A leading lane dimension equals each lane run alone."""
    rng = np.random.default_rng(11)
    lanes = [_tables(rng, 999, 77, itime_hi=2**31 - 1,
                     explicit_prio=explicit_prio) for _ in range(4)]
    r2 = max(l[5] for l in lanes)
    cols = [np.stack([l[i] for l in lanes]) for i in range(4)]
    prio = None if not explicit_prio else np.stack([l[4] for l in lanes])
    for fn in (cycle_core_ref, cycle_core):
        got = _port(fn, *cols, prio, r2)
        for b, l in enumerate(lanes):
            one = _port(fn, *l[:5], r2)
            assert all((g[b] == o).all() for g, o in zip(got, one))


def test_cpu_cycle_core_is_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    out, itime, ok, ch_ok, prio, r2 = _tables(rng, 300, 20,
                                              explicit_prio=True)
    before = cycle_core.launches
    got = _port(cycle_core, out, itime, ok, ch_ok, prio, r2)
    want = _port(cycle_core_ref, out, itime, ok, ch_ok, prio, r2)
    assert cycle_core.launches == before
    assert all((a == b).all() for a, b in zip(got, want))


def test_r2_contract_checked():
    ok = torch.ones(5, dtype=torch.bool)
    z = torch.zeros(5, dtype=torch.int32)
    ch = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="power of two"):
        cycle_core_ref(z, z, ok, ch, r2=6)
    with pytest.raises(ValueError, match="r2"):
        cycle_core_ref(z, z, ok, ch, r2=4)          # 5 rows need r2 >= 5
    with pytest.raises(ValueError, match="r2"):
        cycle_core_ref(z, z, ok, ch, r2=8, prio=z + 8)
    check_r2(8, 5, None)
    check_r2(16, 5, z + 15)


# --- the CUDA wrapper's checks, which need no card -------------------------

from repro_torch.kernels.netsim import ops as netsim_ops


def _good_cycle_args(B=2, N=10, E=4, explicit_prio=True):
    rng = np.random.default_rng(1)
    lanes = [_tables(rng, N, E, explicit_prio=explicit_prio)
             for _ in range(B)]
    cols = [torch.as_tensor(np.stack([l[i] for l in lanes]))
            for i in range(4)]
    prio = (torch.as_tensor(np.stack([l[4] for l in lanes]))
            if explicit_prio else None)
    return cols, prio, max(l[5] for l in lanes)


@pytest.mark.parametrize("index,bad,match", [
    (0, lambda x: x.long(), "out must be torch.int32"),
    (1, lambda x: x.float(), "itime must be torch.int32"),
    (2, lambda x: x.int(), "ok must be torch.bool"),
    (3, lambda x: x[:, :-1].int(), "ch_ok must be torch.bool"),
    (3, lambda x: torch.cat([x, x], 1)[:, ::2],
     "ch_ok must be contiguous along the channel axis"),
    (4, lambda x: x.long(), "prio must be torch.int32"),
])
def test_cycle_core_operands_rejections(index, bad, match):
    cols, prio, r2 = _good_cycle_args()
    args = cols + [prio]
    args[index] = bad(args[index])
    with pytest.raises(ValueError, match=match):
        netsim_ops.cycle_core_operands(*args[:4], r2, args[4])


def test_cycle_core_operands_r2_and_empty():
    cols, prio, r2 = _good_cycle_args(explicit_prio=False)
    with pytest.raises(ValueError, match="power of two"):
        netsim_ops.cycle_core_operands(*cols, 6)
    with pytest.raises(ValueError, match="empty problem"):
        netsim_ops.cycle_core_operands(cols[0][:, :0], cols[1][:, :0],
                                       cols[2][:, :0], cols[3], r2)
    rows, B, N, E = netsim_ops.cycle_core_operands(*cols, r2)
    assert (B, N, E) == (2, 10, 4) and len(rows) == 3


@pytest.mark.parametrize("kernel", netsim_ops.KERNELS)
@pytest.mark.parametrize("explicit_prio", [False, True])
def test_cpu_named_kernel_runs_the_plain_version(kernel, explicit_prio):
    """On the CPU a named kernel still runs the plain version and counts
    no launch (the coop kernel's refusal of an explicit priority is a
    CUDA-side check, `ops._pick`)."""
    cols, prio, r2 = _good_cycle_args(B=3, N=50, E=9,
                                      explicit_prio=explicit_prio)
    before = cycle_core.launches, dict(cycle_core.launches_by_kernel)
    got = cycle_core(*cols, r2=r2, prio=prio, kernel=kernel)
    want = cycle_core_ref(*cols, r2=r2, prio=prio)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cycle_core.launches, cycle_core.launches_by_kernel) == before


def test_cycle_core_rejects_unknown_kernel():
    cols, prio, r2 = _good_cycle_args()
    with pytest.raises(ValueError, match="kernel must be one of"):
        cycle_core(*cols, r2=r2, prio=prio, kernel="three-pass")
