"""The port's collectives (`repro_torch.core.collectives`) and
`optim.compression.pod_compressed_psum` on 8 `gloo` ranks, held against
the reference's `shard_map` outputs on the same inputs.

The reference runs in a subprocess with 8 forced host devices, as
`tests/test_collectives.py` runs it, and writes its outputs to an npz;
the port runs `torch_rank_jobs.run_ranks` (a process a
rank, a `FileStore` in the test's tmp dir, a time limit on the whole)
on the same (2, 4) mesh with the same blocks.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_rank_jobs import run_ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from repro.core import collectives as C
    from repro.optim.compression import pod_compressed_psum

    mesh = jax.make_mesh((2, 4), ("data", "model"))
    x = np.load(sys.argv[2])["x"]
    y = np.load(sys.argv[2])["y"]

    def f(fn, m=mesh, spec=P("data", "model")):
        return jax.jit(shard_map(fn, mesh=m, in_specs=spec,
                                 out_specs=spec))

    out = {}
    for tag, a in (("x", x), ("y", y)):
        out[tag + "_psum_model"] = f(lambda s: jax.lax.psum(s, "model"))(a)
        out[tag + "_psum_all"] = f(
            lambda s: jax.lax.psum(s, ("model", "data")))(a)
        out[tag + "_ring"] = f(lambda s: C.ring_all_reduce(s, "model"))(a)
        out[tag + "_bidir"] = f(
            lambda s: C.bidir_ring_all_reduce(s, "model"))(a)
        out[tag + "_hier"] = f(
            lambda s: C.hierarchical_psum(s, "model", "data"))(a)
        out[tag + "_2d"] = f(lambda s: C.psum_2d(s, "model", "data"))(a)

    pod = jax.make_mesh((2, 4), ("pod", "data"))
    g, e = np.load(sys.argv[2])["g"], np.load(sys.argv[2])["e"]
    pspec = P("pod", "data")
    fn = jax.jit(shard_map(
        lambda gg, ee: pod_compressed_psum({"w": gg}, {"w": ee}, "pod"),
        mesh=pod, in_specs=(pspec, pspec),
        out_specs=({"w": pspec}, {"w": pspec})))
    s, ne = fn(g, e)
    out["pod_sum"], out["pod_err"] = s["w"], ne["w"]
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
""")

FNS = ("ring", "bidir", "hier", "2d")


def _inputs():
    x = (np.arange(8 * 24, dtype=np.float32).reshape(8, 24) * 0.37 - 11.0)
    y = np.cumsum(np.ones((8, 36), np.float32), axis=1)
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 12)).astype(np.float32)
    e = (rng.standard_normal((8, 12)) * 1e-3).astype(np.float32)
    return {"x": x, "y": y, "g": g, "e": e}


def _block(a, i, j, ni, nj):
    r, c = a.shape[0] // ni, a.shape[1] // nj
    return a[i * r:(i + 1) * r, j * c:(j + 1) * c]


def _ranks_collectives(rank, world, inputs):
    """Each rank's block of every output (mesh (2, 4), rank = data * 4 +
    model)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import collectives as C
    from repro_torch.optim.compression import pod_compressed_psum
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    out = {}
    for tag in ("x", "y"):
        s = torch.from_numpy(_block(inputs[tag], d, m, 2, 4).copy())
        out[tag + "_ring"] = C.ring_all_reduce(s, mesh, "model")
        out[tag + "_bidir"] = C.bidir_ring_all_reduce(s, mesh, "model")
        out[tag + "_hier"] = C.hierarchical_psum(s, mesh, "model", "data")
        out[tag + "_2d"] = C.psum_2d(s, mesh, "model", "data")
    pod = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    p, q = pod.get_local_rank("pod"), pod.get_local_rank("data")
    g = torch.from_numpy(_block(inputs["g"], p, q, 2, 4).copy())
    e = torch.from_numpy(_block(inputs["e"], p, q, 2, 4).copy())
    s, ne = pod_compressed_psum({"w": g}, {"w": e}, "pod", mesh=pod)
    out["pod_sum"], out["pod_err"] = s["w"], ne["w"]
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE,
                          str(tmp / "ref.npz"), str(tmp / "in.npz")],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = run_ranks(_ranks_collectives, 8, tmp / "store", (inputs,),
                     timeout=240)
    return inputs, ref, port


def _assemble(port, key, ni=2, nj=4):
    rows = [np.concatenate([port[i * nj + j][key] for j in range(nj)],
                           axis=1) for i in range(ni)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("tag", ["x", "y"])
@pytest.mark.parametrize("fn", FNS)
def test_collective_matches_reference(both, fn, tag):
    """ring / bidir over "model", hierarchical and 2D over ("model",
    "data"); y's [4, 9] blocks take the padding path of the bidir ring."""
    _, ref, port = both
    got = _assemble(port, f"{tag}_{fn}")
    np.testing.assert_allclose(got, ref[f"{tag}_{fn}"], rtol=1e-5,
                               atol=1e-5)
    want = ref[f"{tag}_psum_model"] if fn in ("ring", "bidir") \
        else ref[f"{tag}_psum_all"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pod_compressed_psum_bit_for_bit(both):
    """int8 + error feedback over the pod axis: the int32 sums times the
    max scale equal the reference's bit for bit.  The new error is
    ``corrected - q * scale``, which XLA:CPU fuses into one FMA: it agrees
    to the last bits (1e-6 absolute on errors of ~1e-2)."""
    _, ref, port = both
    np.testing.assert_array_equal(_assemble(port, "pod_sum"), ref["pod_sum"])
    np.testing.assert_allclose(_assemble(port, "pod_err"), ref["pod_err"],
                               rtol=0, atol=1e-6)


def test_pod_compressed_psum_needs_a_process_group():
    from repro_torch.optim.compression import pod_compressed_psum
    g = {"w": torch.ones(2, 2)}
    with pytest.raises(RuntimeError, match="process group"):
        pod_compressed_psum(g, {"w": torch.zeros(2, 2)}, mesh=None)


def _ranks_recorded(rank, world):
    """The collectives one rank records in a hierarchical psum and a ring
    on a (2, 4) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import collectives as C
    from repro_torch.runtime.hlo_analysis import (collective_bytes,
                                                  record_collectives)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    x = torch.ones(8, 6)
    with record_collectives() as rec:
        C.hierarchical_psum(x, mesh, "model", "data")
        C.ring_all_reduce(x, mesh, "model")
    return collective_bytes(rec, {"data": 2, "model": 4})


def test_recorder_sees_the_port_s_collectives(tmp_path):
    """hierarchical_psum: a reduce-scatter of the [8, 6] fp32 block and an
    all-gather of its [2, 6] shard on "model", an all-reduce of the shard
    on "data"; the ring: 2 x 3 permutes of a [2, 6] chunk on "model"."""
    res = run_ranks(_ranks_recorded, 8, tmp_path / "store", timeout=120)
    for r in res:
        assert r["by_op"] == {"reduce-scatter": 192, "all-reduce": 48,
                              "all-gather": 48, "collective-permute": 288}
        assert r["by_axis"] == {"model": 192 + 48 + 288, "data": 48}
