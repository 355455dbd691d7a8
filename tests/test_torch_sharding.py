"""The port's sharding rules (`repro_torch.runtime.sharding`) against the
reference's (`repro.runtime.sharding`).

The first tests mirror the reference's own `tests/test_sharding.py` one
for one on the port's rules.  The parity tests hold the port's specs to
the reference's for every parameter of the 10 registered architectures
at full width, on the reference's `FakeMesh` (16 x 16) and `FakePodMesh`
(2 x 16 x 16): the reference's specs by `jax.eval_shape` of its
`init_params`, the port's on a `meta`-device `Transformer`.  A port
parameter is the reference's stacked leaf without its leading (group or
encoder-layer) dim, so its spec is the reference's without the leading
None.  The batch and cache specs are compared on each arch's
`input_specs` and `init_cache` at `decode_32k` (and the batch on every
shape).  Placement (`shardings`, `make_constrain`) runs on a one-process
`fake` group of 8 ranks.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import LM_SHAPES, shape_by_name
from repro.models import transformer as JTF
from repro.runtime import sharding as JSH
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TTF
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import P


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# --- the reference's unit tests, on the port's rules --------------------------

def test_embed_vocab_parallel():
    spec = SH.param_spec(("embed",), (122880, 2304), FakeMesh)
    assert spec[0] == "model"


def test_odd_vocab_not_sharded_on_model():
    spec = SH.param_spec(("embed",), (122753, 2304), FakeMesh)
    assert spec[0] is None


def test_attention_col_row_parallel():
    q = SH.param_spec(("blocks", "sub0", "mix", "q", "w"),
                      (40, 2304, 2304), FakeMesh)
    o = SH.param_spec(("blocks", "sub0", "mix", "o", "w"),
                      (40, 2304, 2304), FakeMesh)
    assert q[0] is None and q[2] == "model" and q[1] in (None, "data")
    assert o[0] is None and o[1] == "model" and o[2] in (None, "data")
    q_small = SH.param_spec(("blocks", "sub0", "mix", "q", "w"),
                            (40, 512, 512), FakeMesh)
    assert q_small == P(None, None, "model")
    # the port's un-stacked names: the same rule on the logical shape
    specs = SH.tree_param_specs(
        {"blocks.0.sub0.mix.q.w": _meta((2304, 2304)),
         "blocks.0.sub0.mix.o.w": _meta((2304, 2304))}, FakeMesh)
    assert specs["blocks.0.sub0.mix.q.w"] == P(q[1], q[2])
    assert specs["blocks.0.sub0.mix.o.w"] == P(o[1], o[2])


def test_expert_parallelism():
    spec = SH.param_spec(("blocks", "sub0", "ffn", "wi"),
                         (94, 128, 4096, 1536), FakeMesh)
    assert spec[1] == "model"
    assert spec[2] == "data"


def test_router_replicated():
    spec = SH.param_spec(("blocks", "sub0", "ffn", "router"),
                         (94, 4096, 128), FakeMesh)
    assert spec == P(None, None, None)


def test_batch_specs_divisible_and_batch1():
    specs = SH.batch_specs({"tokens": _meta((256, 4096), torch.int32)},
                           FakeMesh)
    assert specs["tokens"][0] == "data"
    specs = SH.batch_specs({"tokens": _meta((1, 524288), torch.int32)},
                           FakeMesh)
    assert specs["tokens"][0] is None
    assert specs["tokens"][1] == "data"


def test_pod_mesh_dp_axes():
    specs = SH.batch_specs({"tokens": _meta((512, 128), torch.int32)},
                           FakePodMesh)
    assert specs["tokens"][0] == ("pod", "data")


def test_cache_specs_kv_and_window_sharding():
    cache = {"prelude": [], "postlude": [],
             "blocks": {"sub0": {
                 "k": _meta((40, 128, 32768, 8, 128)),
                 "v": _meta((40, 128, 32768, 8, 128)),
                 "idx": _meta((40,), torch.int32)}}}
    specs = SH.cache_specs(cache, FakeMesh)
    kspec = specs["blocks"]["sub0"]["k"]
    assert kspec[1] == "data"
    assert kspec[2] == "model"


def test_opt_state_specs_add_data_sharding():
    pspecs = {"w": P(None, "model")}
    shapes = {"w": _meta((2304, 2304))}
    ospecs = SH.opt_state_specs(pspecs, shapes, FakeMesh)
    assert ospecs["w"] == P("data", "model")


# --- parity with the reference at full width -----------------------------------

ARCHS = sorted(jreg.ARCHS)
MESHES = {"single": FakeMesh, "pod": FakePodMesh}


def _ref_leaf(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _entries(spec, n):
    e = tuple(spec)
    return e + (None,) * (n - len(e))


@pytest.fixture(scope="module")
def shapes_of():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jreg.get_config(arch)
            ref = jax.eval_shape(partial(JTF.init_params, cfg=cfg),
                                 jax.ShapeDtypeStruct((2,), jnp.uint32))
            port = dict(TTF.Transformer(treg.get_config(arch), "meta")
                        .named_parameters())
            cache[arch] = (ref, port)
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(shapes_of, arch, mesh):
    """Every parameter's spec (and its AdamW state's) is the reference's,
    once the stacked dim is dropped.  The one departure: where the
    reference's ZeRO rule puts "data" on a stacked group dim (a group
    count the data axis divides), the port, whose groups are separate
    tensors, applies the rule to the first logical dim instead."""
    fm = MESHES[mesh]
    ref, port = shapes_of(arch)
    rspecs = JSH.tree_param_specs(ref, fm)
    rospecs = JSH.opt_state_specs(rspecs, ref, fm)
    pspecs = SH.tree_param_specs(port, fm)
    ospecs = SH.opt_state_specs(pspecs, port, fm)
    assert set(pspecs) == set(port)
    for name, t in port.items():
        path, stacked = SH.reference_path(name)
        leaf = _ref_leaf(ref, path)
        r = _entries(_ref_leaf(rspecs, path), len(leaf.shape))
        ro = _entries(_ref_leaf(rospecs, path), len(leaf.shape))
        assert tuple(leaf.shape[1:] if stacked else leaf.shape) \
            == tuple(t.shape), name
        assert tuple(pspecs[name]) == (r[1:] if stacked else r), name
        if stacked and ro[0] is not None:
            assert ro[0] == "data" and r[0] is None, name
            assert tuple(ospecs[name]) == tuple(SH.opt_state_specs(
                {name: pspecs[name]}, {name: t}, fm)[name]), name
        else:
            assert tuple(ospecs[name]) == (ro[1:] if stacked else ro), name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    fm = MESHES[mesh]
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for shape in LM_SHAPES:
        rb = JSH.batch_specs(jreg.input_specs(jcfg, shape), fm)
        pb = SH.batch_specs(treg.input_specs(tcfg, shape), fm)
        assert {k: tuple(v) for k, v in rb.items()} \
            == {k: tuple(v) for k, v in pb.items()}, shape.name
    shape = shape_by_name("decode_32k")
    B, S = shape.global_batch, shape.seq_len
    rc = jax.eval_shape(partial(JTF.init_cache, jcfg, B, S))
    pc = TTF.init_cache(tcfg, B, S, device="meta")
    rspec, pspec = JSH.cache_specs(rc, fm), SH.cache_specs(pc, fm)
    pleaves = dict(SH._tree_leaves(pc))
    sleaves = dict(SH._tree_leaves(pspec))
    n = 0
    for path, leaf in pleaves.items():
        rleaf = _ref_leaf(rc, path)
        assert tuple(rleaf.shape) == tuple(leaf.shape), path
        assert tuple(sleaves[path]) == _entries(_ref_leaf(rspec, path),
                                                leaf.ndim), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(rc))


# --- placement ------------------------------------------------------------------

@pytest.fixture
def fake_mesh():
    from repro_torch.launch.dryrun import fake_group
    from torch.distributed.device_mesh import init_device_mesh
    with fake_group(8):
        yield init_device_mesh("cpu", (2, 4),
                               mesh_dim_names=("data", "model"))


def test_placements_of_specs(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    assert SH.placements(P("data", "model"), fake_mesh) == (Shard(0),
                                                            Shard(1))
    assert SH.placements(P(None, "data"), fake_mesh) == (Shard(1),
                                                         Replicate())
    assert SH.placements(P(), fake_mesh) == (Replicate(), Replicate())
    tree = SH.shardings({"a": P("model"), "b": [P(None, "data")]},
                        fake_mesh)
    assert tree == {"a": (Replicate(), Shard(0)),
                    "b": [(Shard(1), Replicate())]}
    t = SH.distribute(torch.zeros(8, 12), P("data", "model"), fake_mesh)
    assert tuple(t.to_local().shape) == (4, 3)


def test_make_constrain_specs_and_plain_identity(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    con = SH.make_constrain(fake_mesh)
    x = torch.zeros(4, 8, 16)
    assert con(x) is x                       # plain tensors pass through
    assert con.spec_of(x) == P("data", "model", None)
    assert con.spec_of(x, "gather") == P("data", None, None)
    assert con.spec_of(x, "logits") == P("data", None, "model")
    assert con.spec_of(torch.zeros(4, 2, 6), "logits") == P("data", None,
                                                            None)
    assert SH.make_constrain(fake_mesh, seq_parallel=False).spec_of(x) \
        == P("data", None, None)
    d = SH.distribute(x, P("data", None, None), fake_mesh)
    assert con(d).placements == (Shard(0), Shard(1))
    assert con(d, "gather").placements == (Shard(0), Replicate())
