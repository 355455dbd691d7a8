"""The port's `Checkpointer` (`repro_torch.checkpoint`): the reference's
own tests of `tests/test_checkpoint.py` on the port, the on-disk format
shared with the reference in both directions, bit for bit (a bf16
tensor, an fp32 / int32 tree, a Python scalar, a `SimState` after some
cycles), the port's older int16-pattern bf16 snapshots, and the elastic
restore onto another mesh (`restore(..., shardings=)`) on 2 gloo ranks
through `torch_rank_jobs.run_ranks`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_rank_jobs as jobs  # noqa: E402
from repro import checkpoint as JCK  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core import traffic as JTR  # noqa: E402
from repro.core.simulator import SimConfig as JConfig  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import restore_sim_state  # noqa: E402
from repro_torch.checkpoint import save_sim_state  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.core import traffic as PTR  # noqa: E402
from repro_torch.core.engine import SimState, build_lane  # noqa: E402
from repro_torch.core.engine import make_state, make_step  # noqa: E402
from repro_torch.core.engine import run_scan_batched  # noqa: E402
from repro_torch.core.routing import num_vcs  # noqa: E402
from repro_torch.core.simulator import SimConfig  # noqa: E402

torch.set_num_threads(1)

TINY = dict(a=1, b=1, m=2, n=6, noc=2, g=1)
BF16 = [1.5, -2.25, 3.0e-2, 65504.0]


def _tiny_state():
    net = PT.build_switchless(PT.SwitchlessParams(**TINY), "tiny")
    cfg = SimConfig(warmup=10, measure=50)
    NV = (num_vcs("switchless", cfg.vc_mode, cfg.nonminimal)
          * cfg.vcs_per_class)
    return make_state(net, cfg, NV, (2,), device="cpu")


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _leaves(state: SimState) -> dict:
    out = {k: v for k, v in vars(state).items() if k != "stats"}
    out.update({f"stats.{k}": v for k, v in vars(state.stats).items()})
    return {k: np.asarray(v) for k, v in out.items()}


# --- the reference's tests, on the port ---------------------------------

def test_bfloat16_void_bytes_reinterpreted_not_converted(tmp_path):
    x = torch.tensor(BF16, dtype=torch.bfloat16)
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(0, {"x": x})
    with np.load(tmp_path / "step-00000000" / "state.npz") as z:
        assert z["x"].dtype == np.dtype("V2")       # the reference's format
    restored, step = ck.restore({"x": torch.zeros_like(x)})
    assert step == 0
    assert restored["x"].dtype == torch.bfloat16
    assert np.array_equal(_bits(restored["x"]), _bits(x))


def test_typed_dtype_mismatch_converts_not_views(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"c": np.arange(5, dtype=np.int32)})
    restored, _ = ck.restore({"c": np.zeros(5, dtype=np.float32)})
    assert restored["c"].dtype == np.float32
    assert np.array_equal(restored["c"], [0.0, 1.0, 2.0, 3.0, 4.0])
    # a typed mismatch into a bf16 tensor converts too
    ck.save(1, {"c": np.asarray(BF16, dtype=np.float32)})
    restored, _ = ck.restore({"c": torch.zeros(4, dtype=torch.bfloat16)})
    assert torch.equal(restored["c"],
                       torch.tensor(BF16).to(torch.bfloat16))


def test_python_scalar_leaves_round_trip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"cycle": 128, "arr": np.ones(3)})
    restored, _ = ck.restore({"cycle": 0, "arr": np.zeros(3)})
    assert int(restored["cycle"]) == 128


def test_retention_keeps_newest_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (5, 6, 7):
        ck.save(step, {"x": np.full(2, step)})
    assert ck.list_steps() == [6, 7]
    assert ck.latest_step() == 7
    restored, step = ck.restore({"x": np.zeros(2)})
    assert step == 7 and restored["x"][0] == 7
    restored, step = ck.restore({"x": np.zeros(2)}, step=6)
    assert step == 6 and restored["x"][0] == 6


def test_restore_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore({"x": np.zeros(1)})


def test_sim_state_public_api_round_trip_exact(tmp_path):
    state = _tiny_state()
    host = _leaves(state)
    path = save_sim_state(str(tmp_path), 3, state,
                          extra={"round": 3, "pending": [[1, 0, 0, 2]]},
                          keep=2)
    assert path.endswith("step-00000003")
    restored, extra, step = restore_sim_state(str(tmp_path), state)
    assert step == 3
    assert extra == {"round": 3, "pending": [[1, 0, 0, 2]]}
    back = _leaves(restored)
    assert back.keys() == host.keys()
    for k, a in host.items():
        assert a.dtype == back[k].dtype and np.array_equal(a, back[k]), k


# --- one format for both packages ---------------------------------------

def test_old_int16_pattern_snapshot_still_restores_into_bf16(tmp_path):
    """The port wrote bf16 leaves as int16 bit patterns before it took the
    reference's format: such a snapshot still restores bit for bit."""
    x = torch.tensor(BF16, dtype=torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"x": _bits(x).copy()})
    restored, _ = ck.restore({"x": torch.zeros_like(x)})
    assert restored["x"].dtype == torch.bfloat16
    assert np.array_equal(_bits(restored["x"]), _bits(x))


def _tree(rng):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "opt": {"count": rng.integers(-9, 9, 5).astype(np.int32),
                    "mu": [rng.normal(size=2).astype(np.float32)]},
            "cycle": 4099}


def _check_tree(got, want):
    assert np.array_equal(np.asarray(got["w"]), want["w"])
    assert np.asarray(got["w"]).dtype == np.float32
    assert np.array_equal(np.asarray(got["opt"]["count"]),
                          want["opt"]["count"])
    assert np.asarray(got["opt"]["count"]).dtype == np.int32
    assert np.array_equal(np.asarray(got["opt"]["mu"][0]),
                          want["opt"]["mu"][0])
    assert int(got["cycle"]) == 4099


def test_reference_snapshot_restores_in_the_port(tmp_path):
    """bf16, fp32 / int32 and Python scalar leaves written by the
    reference's `Checkpointer` restore in the port bit for bit."""
    want = _tree(np.random.default_rng(1))
    x = jnp.asarray(BF16, dtype=jnp.bfloat16)
    JCK.Checkpointer(str(tmp_path)).save(2, dict(want, x=x))
    template = dict(_tree(np.random.default_rng(9)),
                    x=torch.zeros(4, dtype=torch.bfloat16), cycle=0)
    got, step = Checkpointer(str(tmp_path)).restore(template)
    assert step == 2
    _check_tree(got, want)
    assert got["x"].dtype == torch.bfloat16
    assert np.array_equal(_bits(got["x"]), _bits(x))


def test_port_snapshot_restores_in_the_reference(tmp_path):
    """The same leaves written by the port restore in the reference bit
    for bit (before the port took the reference's format its int16 bf16
    patterns came back converted, as integers)."""
    want = _tree(np.random.default_rng(1))
    x = torch.tensor(BF16, dtype=torch.bfloat16)
    Checkpointer(str(tmp_path)).save(2, dict(want, x=x))
    template = dict(_tree(np.random.default_rng(9)),
                    x=jnp.zeros(4, dtype=jnp.bfloat16), cycle=0)
    got, step = JCK.Checkpointer(str(tmp_path)).restore(template)
    assert step == 2
    _check_tree(got, want)
    assert np.asarray(got["x"]).dtype == jnp.bfloat16
    assert np.array_equal(_bits(got["x"]), _bits(x))


@pytest.fixture(scope="module")
def run_states():
    """(reference, port) states of the tiny net after 40 cycles of the
    same two lanes (`run_scan_batched` in each package: equal)."""
    cfg = dict(warmup=10, measure=50)
    jnet = JT.build_switchless(JT.SwitchlessParams(**TINY), "tiny")
    pnet = PT.build_switchless(PT.SwitchlessParams(**TINY), "tiny")
    jcfg, pcfg = JConfig(**cfg), SimConfig(**cfg)
    jstep, jc = JE.make_step(jnet, jcfg, JTR.uniform(jnet))
    pstep, pc = make_step(pnet, pcfg, PTR.uniform(pnet), device="cpu")
    js = JE.run_scan_batched(
        jstep, 40, 10, JE.make_state(jnet, jcfg, jc["NV"], (2,)),
        jnp.asarray([0.4, 0.8], jnp.float32),
        jnp.stack([jax.random.PRNGKey(s) for s in (0, 1)]),
        JE.build_lane(jnet, jcfg), False)
    ps = run_scan_batched(
        pstep, 40, 10, make_state(pnet, pcfg, pc["NV"], (2,), device="cpu"),
        torch.tensor([0.4, 0.8]), torch.stack([jr.PRNGKey(s) for s in (0, 1)]),
        build_lane(pnet, pcfg, device="cpu"), False)
    return js, ps


def _jax_leaves(state) -> dict:
    """`_leaves` of a reference `SimState`, by the port's field names."""
    get = lambda k: (getattr(state.stats, k[len("stats."):])
                     if k.startswith("stats.") else getattr(state, k))
    return {k: np.asarray(get(k)) for k in _leaves(_tiny_state())}


def test_sim_state_crosses_both_ways(tmp_path, run_states):
    js, ps = run_states
    want = _leaves(ps)
    assert want["stats.hops"].sum() > 0
    for k, a in _jax_leaves(js).items():
        assert np.array_equal(a, want[k]), k
    # reference -> port
    JCK.save_sim_state(str(tmp_path / "ref"), 40, js, extra={"lanes": 2})
    got, extra, step = restore_sim_state(str(tmp_path / "ref"),
                                         _tiny_state())
    assert (extra, step) == ({"lanes": 2}, 40)
    for k, a in _leaves(got).items():
        assert a.dtype == want[k].dtype and np.array_equal(a, want[k]), k
    # port -> reference
    save_sim_state(str(tmp_path / "port"), 40, ps, extra={"lanes": 2})
    template = jax.tree.map(np.zeros_like, js)
    got, extra, step = JCK.restore_sim_state(str(tmp_path / "port"),
                                             template)
    assert (extra, step) == ({"lanes": 2}, 40)
    for k, a in _jax_leaves(got).items():
        assert a.dtype == want[k].dtype and np.array_equal(a, want[k]), k


# --- elastic restore onto another mesh -----------------------------------

def test_restore_with_shardings_onto_another_mesh(tmp_path):
    """Written from a ("data" 2, "model" 1) mesh, restored onto (1, 2) by
    `shardings`: each rank's local shard is its chunk of the saved array
    (torch's chunking, the last chunk short where 2 does not divide the
    dim) and `full()` the saved array, for fp32, an odd-sized bf16 leaf
    and an int32 leaf whose sharded dim 2 does not divide."""
    rng = np.random.default_rng(4)
    bf16 = torch.from_numpy(rng.normal(size=5).astype(np.float32)).to(
        torch.bfloat16)
    saved = {"w": rng.normal(size=(6, 4)).astype(np.float32),
             "b": _bits(bf16).copy(),
             "n": rng.integers(-99, 99, (3, 5)).astype(np.int32)}
    write = {"w": ("data", None), "b": ("data",), "n": (None, None)}
    read = {"w": (None, "model"), "b": ("model",), "n": (None, "model")}
    dims = {"w": 1, "b": 0, "n": 1}
    out = jobs.run_ranks(jobs.elastic_restore, 2, tmp_path / "store",
                         (str(tmp_path / "ckpt"), saved, write, read))
    for rank, res in enumerate(out):
        assert res["cycle"] == 4096
        for k, a in saved.items():
            assert res["full"][k].dtype == a.dtype
            assert np.array_equal(res["full"][k], a), (rank, k)
            want = torch.chunk(torch.from_numpy(a), 2, dims[k])[rank].numpy()
            assert np.array_equal(res["local"][k], want), (rank, k)
            assert res["mesh"][k] == [[0, 1]]
            assert res["placements"][k] == \
                f"(Replicate(), Shard(dim={dims[k]}))"
    assert out[0]["local"]["b"].shape == (3,)
    assert out[1]["local"]["b"].shape == (2,)
