"""The port's LM stack (`repro_torch.configs`, `models`, `launch.serve`)
against the reference on the CPU, with the same numpy inputs and the same
weights (carried across by `params_from_jax`).

Tolerances: layers at 1e-5 relative and whole models in fp32 at 1e-5
relative with equal greedy tokens (both sides sum fp32 products in
different orders); whole models in bf16 at 2e-2 relative (XLA's and
torch's CPU bf16 dots accumulate and round differently), fed the same
tokens."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_jax

SERVED = ["llama3.2-3b", "minicpm-2b", "chatglm3-6b", "deepseek-moe-16b",
          "qwen3-moe-235b-a22b"]
# (arch, dtype) of the prefill / decode parity.  qwen3-moe in bf16 is left
# out: its second MoE layer's router has token 3's 2nd and 3rd experts
# 0.0026 apart, and the two packages' bf16 roundings of the layer's input
# (4e-3 relative) order them differently, so that token goes to another
# expert; in fp32 the two agree to 1e-5
PARITY = [(a, d) for a in SERVED for d in ("float32", "bfloat16")
          if (a, d) != ("qwen3-moe-235b-a22b", "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _load(module, tree):
    """Copy the numpy leaves of `tree` into `module`'s like-named params."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
    return module


# --- configs -----------------------------------------------------------------

@pytest.mark.parametrize("suffix", ["", "-smoke"])
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_configs_equal_the_reference(arch, suffix):
    j = jreg.get_config(arch + suffix)
    t = treg.get_config(arch + suffix)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.hd, t.num_params(), t.active_params()) == \
        (j.hd, j.num_params(), j.active_params())
    assert t.torch_dtype == {"bfloat16": torch.bfloat16,
                             "float32": torch.float32}[j.dtype]
    for shape in jbase.LM_SHAPES:
        ts = tbase.shape_by_name(shape.name)
        assert dataclasses.asdict(ts) == dataclasses.asdict(shape)
        assert treg.cell_applicable(t, ts) == jreg.cell_applicable(j, shape)
    assert treg._pad_vocab(122753) == jreg._pad_vocab(122753)


# --- layers ------------------------------------------------------------------

def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    scale = rng.standard_normal(64, dtype=np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = TL.rmsnorm(_load(TL.RMSNorm(64), {"scale": scale}),
                     torch.from_numpy(x), 1e-5)
    assert _err(_np(got), want) < 1e-5


@pytest.mark.parametrize("rope_frac", [1.0, 0.5])
def test_apply_rope(rope_frac):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [5]])).astype(np.int32)
    rot = int(16 * rope_frac)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                         JL.rope_freqs(16, 5e5, rot), rot)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        TL.rope_freqs(16, 5e5, rot), rot)
    assert _err(_np(got), want) < 1e-5
    if rot < 16:    # the unrotated tail passes through
        assert np.array_equal(_np(got)[..., rot:], x[..., rot:])


def _dense_tree(rng, d_in, d_out, bias=False):
    p = {"w": rng.standard_normal((d_in, d_out), dtype=np.float32)
         / np.sqrt(d_in)}
    if bias:
        p["b"] = rng.standard_normal(d_out, dtype=np.float32)
    return p


def test_swiglu():
    rng = np.random.default_rng(2)
    tree = {n: _dense_tree(rng, a, b, bias=True)
            for n, a, b in (("wi", 32, 48), ("wg", 32, 48), ("wo", 48, 32))}
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    want = JL.swiglu(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = TL.swiglu(_load(TL.SwiGLU(32, 48, torch.float32, True), tree),
                    torch.from_numpy(x))
    assert _err(_np(got), want) < 1e-5


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 8, 0), (False, None, 0), (True, 8, 5)])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_impls(impl, causal, window, q_offset):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, S, 4, 16), dtype=np.float32)
               for S in (37, 42, 42))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if impl == "chunked":
        kw.update(chunk_q=16, chunk_k=8)     # several ragged chunks
    jf, tf = {"naive": (JL.naive_attention, TL.naive_attention),
              "chunked": (JL.chunked_attention, TL.chunked_attention)}[impl]
    want = jf(*map(jnp.asarray, (q, k, v)), **kw)
    got = tf(*map(torch.from_numpy, (q, k, v)), **kw)
    assert _err(_np(got), want) < 1e-5


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_attention_apply_prefill_then_rolling_decode(impl):
    """A local layer (window 8, cache of 8) prefilled with 12 tokens, then
    decoding 3 tokens, which wrap around the rolling cache."""
    rng = np.random.default_rng(4)
    d, H, KV, hd, W, S = 48, 4, 2, 16, 8, 12
    tree = {n: _dense_tree(rng, a, b) for n, a, b in (
        ("q", d, H * hd), ("k", d, KV * hd), ("v", d, KV * hd),
        ("o", H * hd, d))}
    acfg = dict(d_model=d, num_heads=H, num_kv_heads=KV, head_dim=hd,
                rope_theta=1e4, rope_frac=0.5, window=W, attn_impl=impl,
                chunk_q=8, chunk_k=8)
    jp, jc = jax.tree.map(jnp.asarray, tree), JL.AttnConfig(**acfg)
    tp, tc = _load(TL.Attention(TL.AttnConfig(**acfg), torch.float32), tree), \
        TL.AttnConfig(**acfg)
    jinv = JL.rope_freqs(hd, 1e4, hd // 2)
    tinv = TL.rope_freqs(hd, 1e4, hd // 2)
    jcache = {"k": jnp.zeros((2, W, KV, hd)), "v": jnp.zeros((2, W, KV, hd)),
              "idx": jnp.zeros((), jnp.int32),
              "base": jnp.zeros((), jnp.int32)}
    tcache = {n: torch.from_numpy(np.array(a)) for n, a in jcache.items()}
    x = rng.standard_normal((2, S + 3, d), dtype=np.float32)
    pos = np.tile(np.arange(S + 3, dtype=np.int32), (2, 1))
    steps = [slice(0, S)] + [slice(t, t + 1) for t in range(S, S + 3)]
    for sl in steps:
        want, jcache = JL.attention_apply(jp, jc, jnp.asarray(x[:, sl]),
                                          jnp.asarray(pos[:, sl]), jinv,
                                          jcache)
        got, tcache = TL.attention_apply(tp, tc, torch.from_numpy(x[:, sl]),
                                         torch.from_numpy(pos[:, sl]), tinv,
                                         tcache)
        assert _err(_np(got), want) < 1e-5
        for n in ("k", "v"):
            assert _err(_np(tcache[n]), jcache[n]) < 1e-5
        assert (int(tcache["idx"]), int(tcache["base"])) == \
            (int(jcache["idx"]), int(jcache["base"]))
    assert (int(tcache["idx"]), int(tcache["base"])) == (S + 3, S - W)


# --- the model ---------------------------------------------------------------

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


@pytest.mark.parametrize("arch,dtype", PARITY)
def test_model_prefill_and_decode_match_the_reference(arch, dtype):
    """Train logits, prefill logits and caches, then 8 greedy decode steps.
    In fp32 each side decodes its own greedy tokens and they must agree; in
    bf16 both are fed the reference's tokens."""
    cfg, params, tcfg, model = _models(arch, dtype)
    tol = TOL[dtype]
    B, S, gen = 2, 16, 8
    toks = _tokens(cfg, B, S, seed=1)

    want, _, _ = JTF.forward(params, cfg, {"tokens": jnp.asarray(toks)},
                             "train", attn_impl="naive", remat=False)
    with torch.no_grad():
        got, _, aux = TTF.forward(model, tcfg,
                                  {"tokens": torch.from_numpy(toks)}, "train",
                                  attn_impl="naive")
    assert got.dtype == tcfg.torch_dtype
    assert (float(aux) > 0) == (cfg.moe is not None)
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
                                          cache=tcache, attn_impl="naive")
        assert _err(_np(tlog), jlog) < tol
        jnext = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
        tnext = torch.argmax(tlog[:, -1:], -1).int()
        if dtype == "float32":
            assert np.array_equal(tnext.numpy(), jnext)
        jin, tin = jnp.asarray(jnext), torch.from_numpy(jnext)
        if mode == "prefill":
            for n in ("k", "v"):
                assert _err(_np(tcache["blocks"]["sub0"][n]),
                            jcache["blocks"]["sub0"][n]) < tol
            mode = "decode"
    for n in ("idx", "base"):
        assert np.array_equal(tcache["blocks"]["sub0"][n].numpy(),
                              np.asarray(jcache["blocks"]["sub0"][n]))
    for n in ("k", "v"):
        assert _err(_np(tcache["blocks"]["sub0"][n]),
                    jcache["blocks"]["sub0"][n]) < tol


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
def test_model_attention_impls_match_the_reference(impl):
    """The reference's chunked and Pallas-kernel (interpret mode) paths
    against the port's: the port's kernel entry point runs its plain
    version on the CPU."""
    cfg, params, tcfg, model = _models("llama3.2-3b", "float32", seed=3)
    toks = _tokens(cfg, 2, 24, seed=4)
    want, _, _ = JTF.forward(params, cfg, {"tokens": jnp.asarray(toks)},
                             "train", attn_impl=impl, remat=False)
    with torch.no_grad():
        got, _, _ = TTF.forward(model, tcfg,
                                {"tokens": torch.from_numpy(toks)}, "train",
                                attn_impl=impl)
    assert _err(_np(got), want) < 1e-5


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_then_decode_matches_full_forward(arch):
    """As the reference's test_models: the logits of (prefill S-1 tokens,
    decode token S-1) equal the full forward's at position S-1."""
    _, _, tcfg, model = _models(arch, "float32", seed=2)
    B, S = 2, 16
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


def test_forward_updates_the_callers_cache_in_place():
    """k, v, idx and base all land in the tensors of the cache the caller
    passed, in every stacked group, and `forward` returns that same dict."""
    _, _, tcfg, model = _models("llama3.2-3b", "float32", seed=7)
    B, S = 2, 6
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=8))
    cache = TTF.init_cache(tcfg, B, max_len=S + 2, device="cpu")
    stack = cache["blocks"]["sub0"]
    k_buf, idx_buf = stack["k"], stack["idx"]
    with torch.no_grad():
        _, got, _ = TTF.forward(model, tcfg, {"tokens": toks}, "prefill",
                                cache=cache, attn_impl="naive")
        assert got is cache and stack["idx"] is idx_buf
        assert stack["idx"].tolist() == [S] * stack["idx"].shape[0]
        assert stack["base"].tolist() == [0] * stack["base"].shape[0]
        _, got, _ = TTF.forward(model, tcfg, {"tokens": toks[:, :1]},
                                "decode", cache=cache)
    assert got is cache and stack["k"] is k_buf
    assert stack["idx"].tolist() == [S + 1] * stack["idx"].shape[0]
    assert bool(k_buf[:, :, :S + 1].abs().amax((2, 3, 4)).gt(0).all())
    assert not bool(k_buf[:, :, S + 1:].any())


# --- the serving entry point -------------------------------------------------

def test_generate_equals_a_manual_greedy_loop():
    _, _, tcfg, model = _models("llama3.2-3b", "float32", seed=5)
    toks = _tokens(tcfg, 2, 12, seed=6)
    out, prefill_s, decode_ms = serve.generate(
        model, tcfg, {"tokens": toks}, 4, prefill_impl="kernel", device="cpu")
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert prefill_s > 0 and decode_ms > 0
    cache = TTF.init_cache(tcfg, 2, max_len=16, device="cpu")
    tin, want = torch.from_numpy(toks), []
    with torch.no_grad():
        for mode in ("prefill", "decode", "decode", "decode"):
            logits, cache, _ = TTF.forward(model, tcfg, {"tokens": tin}, mode,
                                           cache=cache, attn_impl="naive")
            tin = torch.argmax(logits[:, -1:], -1).int()
            want.append(tin)
    assert torch.equal(out, torch.cat(want, 1))


def test_serve_main_runs_on_cpu_and_needs_cuda_by_default(capsys):
    out = serve.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"], device="cpu")
    assert out.shape == (2, 3)
    assert "llama3.2-3b-smoke: prefill" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "llama3.2-3b", "--smoke"])
        with pytest.raises(RuntimeError, match="CUDA"):
            TTF.init_params(treg.get_config("llama3.2-3b-smoke"),
                            torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_jax({}, treg.get_config("llama3.2-3b-smoke"))


def test_moe_family_matches_the_reference():
    """deepseek-moe-16b's smoke model (a dense prelude layer, then MoE
    blocks) gives the reference's train logits and aux loss, fp32, at
    1e-5."""
    cfg, params, tcfg, model = _models("deepseek-moe-16b", "float32", seed=9)
    toks = _tokens(cfg, 2, 16, seed=10)
    want, _, want_aux = JTF.forward(
        params, cfg, {"tokens": jnp.asarray(toks)}, "train",
        attn_impl="naive", remat=False)
    with torch.no_grad():
        got, _, aux = TTF.forward(model, tcfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  "train", attn_impl="naive")
    assert _err(_np(got), want) < 1e-5
    assert float(aux) > 0 and _err(_np(aux), want_aux) < 1e-5


def test_params_from_jax_rejects_a_tree_that_does_not_fit():
    cfg, params, tcfg, _ = _models("llama3.2-3b", "float32")
    tree = jax.tree.map(np.asarray, params)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(tree, tcfg, device="cpu")
    del tree["extra"]
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(tree, tcfg, device="cpu")
