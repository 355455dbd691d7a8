"""The port's Mixture-of-Experts FFN (`repro_torch.models.moe`) against the
reference's (`repro.models.moe`) on the CPU: the same numpy inputs, the
reference's weights copied across.

Tolerances: the routing (experts, gates' order, which (token, slot) pairs
are kept) is exact; gates and the aux loss at 1e-6 relative (fp32
softmax on both sides); y in fp32 at 1e-5 relative to its largest value,
in bf16 at 2e-2 (XLA's and torch's CPU bf16 products round differently).
int8 dispatch: each output row is quantized again after the experts'
fp32 products, whose sums both sides order differently, so a value on a
rounding boundary may land one int8 step apart; y is held there to one
step of that row's scale (times its gate) plus the fp32 bar, and all but
0.5 % of its values to the fp32 bar alone.  Gradients (fp32) at 1e-5
relative to each leaf's largest value, 1e-4 in int8 dispatch (the same
one-step rounding, seen through the output scales' gradient)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as TM

D = 32
BASE = dict(num_experts=8, top_k=2, d_expert=24, num_shared=1)


def _err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _pair(dtype, dispatch, capacity_factor, seed=0):
    """The reference's params (dtype) and the port's module with the same
    numbers, and the two configs."""
    kw = dict(BASE, dispatch=dispatch, capacity_factor=capacity_factor)
    jcfg, tcfg = JMoEConfig(**kw), MoEConfig(**kw)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    params = JM.moe_init(jax.random.PRNGKey(seed), D, jcfg, jdt)
    module = TM.MoE(D, tcfg, tdt)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(torch.from_numpy(np.array(leaf)))   # exact: in dtype
    return params, module, jcfg, tcfg


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return x.astype(jnp.bfloat16).astype(np.float32) \
        if dtype == "bfloat16" else x


def _ref_routing(params, x, mcfg):
    """Lines 48-66 of the reference's `moe_apply`: (gates, expert ids,
    kept pairs)."""
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], -1)
    gates, eidx = jax.lax.top_k(probs, mcfg.top_k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    C = TM.capacity(T, mcfg)
    flat_e = eidx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, mcfg.num_experts,
                                    dtype=jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return gates, eidx, pos < C


CASES = [("float32", "bf16"), ("float32", "int8"), ("bfloat16", "bf16"),
         ("bfloat16", "int8")]


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype,dispatch", CASES)
def test_moe_apply_matches_the_reference(dtype, dispatch, capacity_factor):
    """y, aux and the routing of 4 x 32 tokens.  At capacity factor 0.5
    (C = 16 slots for an average load of 32) pairs are dropped, and the
    same ones on both sides."""
    params, module, jcfg, tcfg = _pair(dtype, dispatch, capacity_factor)
    x = _x((4, 32, D), dtype, seed=1)
    jdt = params["wi"].dtype
    want, want_aux = jax.jit(JM.moe_apply, static_argnums=2)(
        params, jnp.asarray(x, jdt), jcfg)
    tx = torch.from_numpy(x).to(module.wi.dtype)
    with torch.no_grad():
        got, aux = TM.moe_apply(module, tx, tcfg)
        gates, eidx, pos, keep, _ = TM.route(module, tx.reshape(-1, D), tcfg)
    assert got.dtype == module.wi.dtype and got.shape == x.shape
    jg, je, jkeep = jax.jit(_ref_routing, static_argnums=2)(
        params, jnp.asarray(x, jdt), jcfg)
    assert np.array_equal(eidx.numpy(), np.asarray(je))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert _err(gates.numpy(), jg) < 1e-6
    assert _err(aux.numpy(), want_aux) < 1e-6
    dropped = int((~keep).sum())
    if capacity_factor < 1:
        assert dropped > 0
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    bar = 1e-5 if dtype == "float32" else 2e-2
    if dispatch == "int8":
        # one output int8 step of each kept (token, slot), times its gate
        ye_scale = _output_steps(module, tx, tcfg)
        step = (ye_scale * gates.numpy() * keep.numpy().reshape(
            gates.shape)).sum(-1).reshape(x.shape[:2])[..., None]
        slack = bar * np.abs(want).max()
        assert (np.abs(got - want) <= step * 1.01 + slack).all()
        assert np.mean(np.abs(got - want) > slack) < 5e-3
    else:
        assert _err(got, want) < bar


@torch.no_grad()
def _output_steps(module, tx, tcfg):
    """The int8 step (scale) of the expert output row each (token, slot)
    reads, [T, K]."""
    T, K, E = tx.shape[0] * tx.shape[1], tcfg.top_k, tcfg.num_experts
    xt = tx.reshape(T, -1)
    gates, eidx, pos, keep, _ = TM.route(module, xt, tcfg)
    C = TM.capacity(T, tcfg)
    xq, scl = TM._quantize(xt)
    e_safe = torch.where(keep, eidx.reshape(-1), E)
    slot = torch.clamp(pos, max=C - 1)
    tok = torch.arange(T).repeat_interleave(K)
    buf = torch.zeros((E + 1, C, xt.shape[1]), dtype=torch.int8).index_put(
        (e_safe, slot), xq[tok])
    sbuf = torch.zeros((E + 1, C)).index_put((e_safe, slot), scl[tok])
    xe = (buf[:E].float() * sbuf[:E][..., None]).to(tx.dtype)
    h = torch.nn.functional.silu(torch.bmm(xe, module.wg)) \
        * torch.bmm(xe, module.wi)
    _, yscl = TM._quantize(torch.bmm(h, module.wo))
    return yscl[torch.clamp(e_safe, max=E - 1), slot].reshape(T, K).numpy()


@pytest.mark.parametrize("dispatch", ["bf16", "int8"])
def test_moe_gradients_match_the_reference(dispatch):
    """d/d(x, router, wi, wg, wo, shared) of sum(y * w) + aux in fp32, with
    drops (capacity factor 0.5).  In int8 dispatch the rounding and the
    integer cast pass no gradient in either package: x's gradient flows
    only through the router, the shared expert and the per-token scales,
    and the port's is held to the reference's."""
    params, module, jcfg, tcfg = _pair("float32", dispatch, 0.5, seed=2)
    x = _x((4, 32, D), "float32", seed=3)
    w = np.random.default_rng(4).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_apply(p, xx, jcfg)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_apply(module, tx, tcfg)
    loss = torch.sum(y * torch.from_numpy(w)) + aux
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [tx] + [p for _, p in
                                              module.named_parameters()])
    bar = 1e-5 if dispatch == "bf16" else 1e-4
    assert _err(grads[0].numpy(), jgx) < bar
    for name, g in zip(names, grads[1:]):
        leaf = jgp
        for part in name.split("."):
            leaf = leaf[part]
        assert _err(g.numpy(), leaf) < bar, name


def test_int8_dispatch_passes_no_gradient_through_the_rounding():
    """The int8 payload carries no gradient (rounding and the integer cast
    stop it, as in the reference); its per-token scales do.  So with the
    scales held constant, the experts' int8 path is a constant to
    autograd, and what reaches x comes from the router, the shared expert
    and the scales."""
    xt = torch.from_numpy(_x((64, D), "float32", seed=6)).requires_grad_()
    xq, scl = TM._quantize(xt)
    assert xq.dtype == torch.int8 and not xq.requires_grad
    assert scl.requires_grad
    assert not (xq.float() * scl.detach()[:, None]).requires_grad


def test_top_k_breaks_ties_to_the_lower_index_as_lax_top_k():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4, [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.1, 0.3, 0.3]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TM.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tokens", [1, 4, 7, 64, 1000])
def test_capacity_is_the_reference_s(tokens):
    """C = max(ceil(T*K*cf/E), min(T*K, 16)) in host integer math; the
    reference computes it inline (`moe.py:60-61`)."""
    for cf in (0.5, 1.0, 1.25, 2.0):
        mcfg = MoEConfig(**dict(BASE, capacity_factor=cf))
        want = max(int(np.ceil(tokens * 2 * cf / 8)), min(tokens * 2, 16))
        assert TM.capacity(tokens, mcfg) == want


def test_moe_reset_draws_the_reference_s_scales():
    mcfg = MoEConfig(**dict(BASE, d_expert=256))
    module = TM.MoE(512, mcfg, torch.float32)
    with torch.no_grad():
        module.reset(torch.Generator().manual_seed(0))
    for p, std in ((module.router, 512 ** -0.5), (module.wi, 512 ** -0.5),
                   (module.wg, 512 ** -0.5), (module.wo, 256 ** -0.5)):
        # truncated at 2 sigma: std 0.8796 of the untruncated one
        p = p.detach()
        assert abs(float(p.std()) / std - 0.8796) < 0.02
        assert float(p.abs().max()) <= 2 * std + 1e-6
    assert module.router.dtype == torch.float32
    assert dataclasses.asdict(mcfg)["dispatch"] == "bf16"
