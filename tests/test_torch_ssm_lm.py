"""The port's Mamba-2 (`models/ssm.py`) and Griffin (`models/rglru.py`)
blocks and the two model families built of them, `mamba2-780m` and
`recurrentgemma-2b`, against the reference on the CPU, with the same
numpy inputs and the same weights (carried across by `params_from_jax`).

Tolerances: fp32 at 1e-5 relative with equal greedy tokens (both sides
sum fp32 products in different orders); bf16 at 2e-2 relative (XLA's and
torch's CPU bf16 paths round differently in places), fed the same tokens.
`attn_impl="kernel"` reaches the scan kernels' plain versions on the CPU
(`ssd_ref`, `rglru_scan_ref`), where the reference runs its plain chunked
and associative scans."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JTF
from repro_torch.configs import registry as treg
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_jax

ARCHS = ["mamba2-780m", "recurrentgemma-2b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _models(arch, dtype, seed=0):
    """The reference's smoke model in `dtype` and the port's with the same
    weights."""
    cfg = dataclasses.replace(jreg.get_config(arch + "-smoke"), dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"), dtype=dtype)
    params = JTF.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


# --- the blocks' pieces ------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 9])
@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv(S, with_cache):
    jx, tx = _x(S, (2, S, 24), "float32")
    jw, tw = _x(1, (4, 24), "float32")
    jb, tb = _x(2, (24,), "float32")
    jc, tc = _x(3, (2, 3, 24), "float32") if with_cache else (None, None)
    want, wcache = JS._causal_conv(jx, jw, jb, jc)
    got, gcache = TS._causal_conv(tx, tw, tb, tc)
    assert _err(_np(got), want) < 1e-6
    assert np.array_equal(_np(gcache), np.asarray(wcache))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 40, 8, 16, 16, 16), (1, 33, 3, 8, 16, 8), (2, 16, 4, 16, 8, 32)])
def test_ssd_chunked_matches_the_reference(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S + H)
    arrs = (rng.standard_normal((B, S, H, P), dtype=np.float32) * 0.5,
            np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(
                np.float32),
            (np.abs(rng.standard_normal(H)) + 0.1).astype(np.float32),
            rng.standard_normal((B, S, N), dtype=np.float32) * 0.3,
            rng.standard_normal((B, S, N), dtype=np.float32) * 0.3)
    wy, ws = JS.ssd_chunked(*map(jnp.asarray, arrs), chunk)
    gy, gs = TS.ssd_chunked(*map(torch.from_numpy, arrs), chunk)
    assert _err(_np(gy), wy) < 1e-5 and _err(_np(gs), ws) < 1e-5


def _mixer(arch, dtype, seed):
    """(reference params, port module) of group 0's first mixer."""
    cfg, params, tcfg, model = _models(arch, dtype, seed)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["sub0"]["mix"])
    return cfg, jp, tcfg, model.blocks[0]["sub0"].mix


def _check_mixer(dtype, use_kernel, japply, tapply, jcache, tcache):
    """No cache, then prefill (S = 12) and 3 decode steps against the
    caches, outputs and every cache entry held to the reference."""
    tol = TOL[dtype]
    jx, tx = _x(7, (2, 15, 64), dtype)
    want, none = japply(jx, None)
    with torch.no_grad():
        got, tnone = tapply(tx, None, use_kernel)
    assert none is None and tnone is None
    assert got.dtype == TDT[dtype] and _err(_np(got), want) < tol
    for sl in [slice(0, 12), slice(12, 13), slice(13, 14), slice(14, 15)]:
        want, jcache = japply(jx[:, sl], jcache)
        with torch.no_grad():
            got, back = tapply(tx[:, sl], tcache, use_kernel)
        assert back is tcache
        assert _err(_np(got), want) < tol
        for name, buf in tcache.items():
            assert buf.dtype == {"conv": TDT[dtype]}.get(name, torch.float32)
            assert _err(_np(buf), jcache[name]) < tol, name


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_matches_the_reference(dtype, use_kernel):
    cfg, jp, tcfg, tp = _mixer("mamba2-780m", dtype, seed=1)
    assert {tp.A_log.dtype, tp.D.dtype, tp.dt_bias.dtype} == {torch.float32}
    jcache = JS.ssm_cache_init(2, cfg.d_model, cfg.ssm, cfg.jdtype)
    tcache = TS.ssm_cache_init(2, tcfg.d_model, tcfg.ssm, tcfg.torch_dtype)
    assert {n: (t.shape, t.dtype) for n, t in tcache.items()} == {
        n: (tuple(a.shape), TDT[str(a.dtype)]) for n, a in jcache.items()}
    _check_mixer(
        dtype, use_kernel,
        lambda x, c: JS.ssm_apply(jp, x, cfg.ssm, cfg.d_model, c),
        lambda x, c, k: TS.ssm_apply(tp, x, tcfg.ssm, tcfg.d_model, c,
                                     use_kernel=k),
        jcache, tcache)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_the_reference(dtype, use_kernel):
    cfg, jp, tcfg, tp = _mixer("recurrentgemma-2b", dtype, seed=2)
    assert tp.lam.dtype == torch.float32
    jcache = JR.rglru_cache_init(2, cfg.d_model, cfg.rglru, cfg.jdtype)
    tcache = TR.rglru_cache_init(2, tcfg.d_model, tcfg.rglru,
                                 tcfg.torch_dtype)
    assert {n: (t.shape, t.dtype) for n, t in tcache.items()} == {
        n: (tuple(a.shape), TDT[str(a.dtype)]) for n, a in jcache.items()}
    _check_mixer(
        dtype, use_kernel,
        lambda x, c: JR.rglru_apply(jp, x, cfg.rglru, c),
        lambda x, c, k: TR.rglru_apply(tp, x, tcfg.rglru, c, use_kernel=k),
        jcache, tcache)


def test_activations_equal_the_reference_in_bf16():
    """silu and the tanh gelu round every step as `jax.nn` does, so in bf16
    they equal the reference bit for bit (`F.silu` / `F.gelu` do not)."""
    jx, tx = _x(11, (4096,), "bfloat16")
    jx, tx = jx * 4, tx * 4
    assert np.array_equal(_np(TS._silu(tx)), _np(jax.nn.silu(jx)))
    assert np.array_equal(_np(TR._gelu_tanh(tx)), _np(jax.nn.gelu(jx)))


# --- the models --------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_and_decode_match_the_reference(arch, dtype, impl):
    """Train logits, prefill logits and every cache, then 8 greedy decode
    steps.  In fp32 each side decodes its own greedy tokens and they must
    agree; in bf16 both are fed the reference's tokens.  The reference
    runs "naive" throughout, the port `impl`."""
    cfg, params, tcfg, model = _models(arch, dtype)
    tol = TOL[dtype]
    B, S, gen = 2, 20, 8
    toks = _tokens(cfg, B, S, seed=1)

    want, _, _ = JTF.forward(params, cfg, {"tokens": jnp.asarray(toks)},
                             "train", attn_impl="naive", remat=False)
    with torch.no_grad():
        got, _, aux = TTF.forward(model, tcfg,
                                  {"tokens": torch.from_numpy(toks)}, "train",
                                  attn_impl=impl)
    assert got.dtype == tcfg.torch_dtype and float(aux) == 0.0
    assert _err(_np(got), want) < tol

    @partial(jax.jit, static_argnames="mode")
    def jstep(params, tokens, cache, mode):
        return JTF.forward(params, cfg, {"tokens": tokens}, mode, cache=cache,
                           attn_impl="naive", remat=False)[:2]

    jcache = JTF.init_cache(cfg, B, max_len=S + gen)
    tcache = TTF.init_cache(tcfg, B, max_len=S + gen, device="cpu")
    jin, tin = jnp.asarray(toks), torch.from_numpy(toks)
    mode = "prefill"
    for _ in range(gen):
        jlog, jcache = jstep(params, jin, jcache, mode)
        with torch.no_grad():
            tlog, tcache, _ = TTF.forward(model, tcfg, {"tokens": tin}, mode,
                                          cache=tcache, attn_impl=impl)
        assert _err(_np(tlog), jlog) < tol
        jnext = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
        tnext = torch.argmax(tlog[:, -1:], -1).int()
        if dtype == "float32":
            assert np.array_equal(tnext.numpy(), jnext)
        jin, tin = jnp.asarray(jnext), torch.from_numpy(jnext)
        mode = "decode"
    for part in ("prelude", "postlude"):
        assert len(tcache[part]) == len(jcache[part])
        for tc, jc in zip(tcache[part], jcache[part]):
            for name in jc:
                assert _err(_np(tc[name]), jc[name]) < tol, (part, name)
    for sub, jc in jcache["blocks"].items():
        for name, arr in jc.items():
            if name in ("idx", "base"):
                assert np.array_equal(tcache["blocks"][sub][name].numpy(),
                                      np.asarray(arr))
            else:
                assert _err(_np(tcache["blocks"][sub][name]), arr) < tol, \
                    (sub, name)


def test_recurrentgemma_prompt_longer_than_the_window():
    """A 48-token prompt on the smoke model (local window 32): the local
    layers keep the last 32 keys (base 16) and decode wraps the ring; the
    logits and greedy tokens follow the reference's."""
    cfg, params, tcfg, model = _models("recurrentgemma-2b", "float32", 4)
    assert cfg.local_window == 32
    B, S, gen = 2, 48, 6
    toks = _tokens(cfg, B, S, seed=5)
    jcache = JTF.init_cache(cfg, B, max_len=S + gen)
    tcache = TTF.init_cache(tcfg, B, max_len=S + gen, device="cpu")
    jin, tin, mode = jnp.asarray(toks), torch.from_numpy(toks), "prefill"
    for _ in range(gen):
        jlog, jcache, _ = JTF.forward(params, cfg, {"tokens": jin}, mode,
                                      cache=jcache, attn_impl="naive",
                                      remat=False)
        with torch.no_grad():
            tlog, tcache, _ = TTF.forward(model, tcfg, {"tokens": tin}, mode,
                                          cache=tcache, attn_impl="kernel")
        assert _err(_np(tlog), jlog) < 1e-5
        nxt = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(tlog[:, -1:], -1).int().numpy(),
                              nxt)
        jin, tin, mode = jnp.asarray(nxt), torch.from_numpy(nxt), "decode"
    local = tcache["blocks"]["sub2"]
    assert local["k"].shape[2] == 32
    assert local["idx"].tolist() == [S + gen - 1] * local["idx"].shape[0]
    assert local["base"].tolist() == [S - 32] * local["base"].shape[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """As the reference's test_models: the logits of (kernel prefill of
    S-1 tokens, decode token S-1) equal the full naive forward's at
    position S-1."""
    _, _, tcfg, model = _models(arch, "float32", seed=2)
    B, S = 2, 40
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=3))
    with torch.no_grad():
        full, _, _ = TTF.forward(model, tcfg, {"tokens": toks}, "train",
                                 attn_impl="naive")
        cache = TTF.init_cache(tcfg, B, max_len=S, device="cpu")
        _, cache, _ = TTF.forward(model, tcfg, {"tokens": toks[:, :S - 1]},
                                  "prefill", cache=cache, attn_impl="kernel")
        dec, _, _ = TTF.forward(model, tcfg, {"tokens": toks[:, S - 1:]},
                                "decode", cache=cache)
    assert _err(_np(dec[:, 0]), _np(full[:, S - 1])) < 1e-5


def test_forward_updates_the_state_caches_in_place():
    """The conv windows and states land in the tensors of the cache the
    caller passed, in every stacked group, and `forward` returns that same
    dict; the kernel entry points run on the CPU without a launch."""
    _, _, tcfg, model = _models("recurrentgemma-2b", "float32", seed=7)
    B, S = 2, 6
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=8))
    cache = TTF.init_cache(tcfg, B, max_len=S + 2, device="cpu")
    bufs = {(sub, n): t for sub, c in cache["blocks"].items()
            for n, t in c.items()}
    launches = rglru_ops.rglru_scan.launches, ssd_ops.ssd_scan.launches
    with torch.no_grad():
        for mode, tin in (("prefill", toks), ("decode", toks[:, :1])):
            _, got, _ = TTF.forward(model, tcfg, {"tokens": tin}, mode,
                                    cache=cache, attn_impl="kernel")
            assert got is cache
    assert (rglru_ops.rglru_scan.launches, ssd_ops.ssd_scan.launches) \
        == launches
    for (sub, n), t in bufs.items():
        assert cache["blocks"][sub][n] is t
    # every group written
    assert bool(cache["blocks"]["sub0"]["h"].abs().amax((1, 2)).gt(0).all())
    assert bool(cache["blocks"]["sub1"]["conv"].abs().amax((1, 2, 3))
                .gt(0).all())


def test_mamba_decode_positions_live_on_the_cache_device():
    """A model with no attention layer takes its decode positions from a
    zero on the cache's own device (a cache on the meta device shows it)."""
    cfg = treg.get_config("mamba2-780m-smoke")
    meta = TTF.init_cache(cfg, 2, 8, device="meta")
    assert TTF._first_idx(meta).device.type == "meta"
    _, _, tcfg, model = _models("mamba2-780m", "float32", seed=9)
    toks = torch.from_numpy(_tokens(tcfg, 2, 5, seed=9))
    cache = TTF.init_cache(tcfg, 2, 8, device="cpu")
    with torch.no_grad():
        TTF.forward(model, tcfg, {"tokens": toks}, "prefill", cache=cache)
        logits, cache, _ = TTF.forward(model, tcfg, {"tokens": toks[:, :1]},
                                       "decode", cache=cache)
    idx = TTF._first_idx(cache)
    assert idx.device == logits.device and int(idx) == 0
    assert logits.shape == (2, 1, tcfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_blocks_weights(arch):
    cfg = treg.get_config(arch + "-smoke")
    model = TTF.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    mix = model.blocks[0]["sub0"].mix
    assert bool(torch.isfinite(mix.conv_w).all()) and mix.conv_w.std() > 0
    if arch.startswith("mamba"):
        assert torch.allclose(torch.exp(mix.A_log[[0, -1]]),
                              torch.tensor([1.0, 16.0]))
        assert bool((mix.D == 1).all()) and not bool(mix.dt_bias.any())
    else:
        a = torch.sigmoid(mix.lam[[0, -1]])
        assert torch.allclose(a, torch.tensor([0.9, 0.999]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "40", "--gen", "3"], device="cpu")
    assert out.shape == (2, 3)
    assert f"{arch}-smoke: prefill" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_on_the_kernel_equals_the_plain_prefill(arch):
    """`generate` with the kernel prefill (the plain versions on the CPU)
    gives the same greedy tokens as with the naive prefill."""
    _, _, tcfg, model = _models(arch, "float32", seed=6)
    toks = _tokens(tcfg, 2, 24, seed=6)
    outs = [serve.generate(model, tcfg, {"tokens": toks}, 5,
                           prefill_impl=impl, device="cpu")[0]
            for impl in ("kernel", "naive")]
    assert torch.equal(outs[0], outs[1])
