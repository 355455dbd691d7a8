"""The port's vision prefix and encoder-decoder (`repro_torch.models.
transformer` with ``prefix_embeds`` / ``src_embeds``, `convert`,
`launch.serve`, `configs.registry.input_specs`) against the reference on
the CPU, with the same numpy inputs and the same weights (carried across
by `params_from_jax`): `phi-3-vision-4.2b-smoke` (4 prefix rows before
the tokens) and `seamless-m4t-medium-smoke` (2 encoder layers, a
cross-attention in each decoder block).

Tolerances: fp32 at 1e-5 relative to the reference's largest value
(logits, caches, loss and each parameter's gradient; both sides sum fp32
products in different orders); bf16 logits at 2e-2 (XLA's and torch's
CPU bf16 dots accumulate and round differently).  The card-vs-CPU cases
of both models are in `tests/test_torch_cuda.py`, which imports no JAX."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import transformer as JTF
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.optimizer import decays

ARCHS = ["phi-3-vision-4.2b", "seamless-m4t-medium"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 12        # batch and prompt of every model test (Sm = S frames)


def _err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _np(x):
    return x.detach().float().numpy()


def _models(arch, dtype="float32", seed=0):
    """The reference's smoke model in `dtype` and the port's with the same
    weights."""
    cfg = dataclasses.replace(jreg.get_config(arch + "-smoke"), dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"), dtype=dtype)
    params = JTF.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _inputs(cfg, seed, labels=False):
    """numpy tokens [B, S] (+ labels), and the model's extra input: a
    vision model's prefix_embeds [B, num_prefix, D], an encoder-decoder's
    src_embeds [B, S, D], fp32 of std 0.02 (each side casts them to its
    model's dtype)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if labels:
        batch["labels"] = rng.integers(-1, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = (rng.standard_normal(
            (B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf(tree, name):
    """The reference leaf of the port's parameter `name` (slice i of a
    stacked leaf for ``blocks.<i>.…`` and ``encoder.<i>.…``), as numpy."""
    parts = name.split(".")
    index = None
    if parts[0] in ("blocks", "encoder"):
        index, parts = int(parts[1]), [parts[0]] + parts[2:]
    leaf = tree
    for part in parts:
        leaf = leaf[int(part)] if isinstance(leaf, list) else leaf[part]
    leaf = np.asarray(leaf, np.float32)
    return leaf if index is None else leaf[index]


# --- the forward -------------------------------------------------------------

@pytest.mark.parametrize("impl,dtype", [
    ("naive", "float32"), ("chunked", "float32"), ("kernel", "float32"),
    ("naive", "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_the_reference(arch, impl, dtype):
    """Train-mode logits over the token positions only, with the prefix
    before the tokens or the source encoded (non-causal, `impl`) and
    cross-attended; the port's kernel entry point runs its plain version
    on the CPU, the reference's Pallas kernel interpret mode."""
    cfg, params, tcfg, model = _models(arch, dtype)
    batch = _inputs(cfg, seed=1)
    want, _, _ = JTF.forward(params, cfg, _j(batch), "train",
                             attn_impl=impl, remat=False)
    with torch.no_grad():
        got, _, _ = TTF.forward(model, tcfg, _t(batch), "train",
                                attn_impl=impl)
    assert got.shape == want.shape == (B, S, cfg.vocab_size)
    assert got.dtype == tcfg.torch_dtype
    assert _err(_np(got), want) < TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """A prefill into a cache of S + gen (+ the prefix) slots, then two
    greedy decode steps (seamless passes src_embeds again, as the serve
    loop does): the logits, equal greedy tokens, the first layer's cache
    and its index, which counts the prefix rows."""
    cfg, params, tcfg, model = _models(arch, seed=2)
    batch = _inputs(cfg, seed=3)
    extra = {k: v for k, v in batch.items() if k == "src_embeds"}
    prefix = cfg.num_prefix if cfg.frontend else 0
    max_len = S + 3 + prefix

    @partial(jax.jit, static_argnames="mode")
    def jstep(params, batch, cache, mode):
        return JTF.forward(params, cfg, batch, mode, cache=cache,
                           attn_impl="naive", remat=False)[:2]

    jcache = JTF.init_cache(cfg, B, max_len=max_len)
    tcache = TTF.init_cache(tcfg, B, max_len=max_len, device="cpu")
    jin, tin, mode = batch, batch, "prefill"
    for _ in range(3):
        jlog, jcache = jstep(params, _j(jin), jcache, mode)
        with torch.no_grad():
            tlog, tcache, _ = TTF.forward(model, tcfg, _t(tin), mode,
                                          cache=tcache, attn_impl="naive")
        assert tlog.shape == jlog.shape
        assert _err(_np(tlog), jlog) < 1e-5
        jnext = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(tlog[:, -1:], -1).int().numpy(),
                              jnext)
        jin = tin = {"tokens": jnext, **extra}
        mode = "decode"
    sub = tcache["blocks"]["sub0"]
    for n in ("k", "v"):
        assert _err(_np(sub[n]), jcache["blocks"]["sub0"][n]) < 1e-5
    assert sub["idx"].tolist() == [S + prefix + 2] * sub["idx"].shape[0]
    assert np.array_equal(sub["idx"].numpy(),
                          np.asarray(jcache["blocks"]["sub0"]["idx"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """The logits of (prefill S-1 tokens on the kernel entry point, decode
    token S-1) equal the full forward's at position S-1."""
    _, _, tcfg, model = _models(arch, seed=4)
    batch = _t(_inputs(tcfg, seed=5))
    extra = {k: v for k, v in batch.items() if k == "src_embeds"}
    with torch.no_grad():
        full, _, _ = TTF.forward(model, tcfg, batch, "train",
                                 attn_impl="naive")
        cache = TTF.init_cache(tcfg, B, S + tcfg.num_prefix, device="cpu")
        head = dict(batch, tokens=batch["tokens"][:, :S - 1])
        _, cache, _ = TTF.forward(model, tcfg, head, "prefill", cache=cache,
                                  attn_impl="kernel")
        dec, _, _ = TTF.forward(
            model, tcfg, {"tokens": batch["tokens"][:, S - 1:], **extra},
            "decode", cache=cache)
    assert _err(_np(dec[:, 0]), _np(full[:, S - 1])) < 1e-5


def test_memory_input_skips_the_encoder():
    """A batch that carries the encoder's output as ``memory`` gives the
    logits of the same batch with the ``src_embeds`` it came from, as in
    the reference, whose decode dry-run feeds ``memory``."""
    cfg, params, tcfg, model = _models("seamless-m4t-medium", seed=6)
    batch = _inputs(cfg, seed=7)
    src = batch.pop("src_embeds")
    with torch.no_grad():
        memory = torch.from_numpy(src)
        mpos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
        inv = TL.rope_freqs(tcfg.hd, tcfg.rope_theta)
        for p in model.encoder:
            memory, _ = TTF._sub_apply(p, tcfg, "enc", "dense", "naive",
                                       memory, mpos, inv, None)
        got, _, _ = TTF.forward(model, tcfg, dict(_t(batch), memory=memory),
                                "train", attn_impl="naive")
    want, _, _ = JTF.forward(params, cfg, dict(_j(batch), src_embeds=src),
                             "train", attn_impl="naive", remat=False)
    assert _err(_np(got), want) < 1e-5


# --- the loss and its gradients ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_the_reference(arch):
    """fp32, naive attention, remat on both sides: the loss and every
    parameter's gradient against `jax.value_and_grad`, the encoder's and
    each decoder block's `cross` / `norm_x` included."""
    cfg, params, tcfg, model = _models(arch, seed=8)
    batch = _inputs(cfg, seed=9, labels=True)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.lm_loss(p, cfg, _j(batch), attn_impl="naive",
                              remat=True), has_aux=True))(params)
    tl, tm = TTF.lm_loss(model, tcfg, _t(batch), attn_impl="naive",
                         remat=True)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(tl, ps)
    assert _err(_np(tl), jl) < 1e-5
    assert _err(_np(tm["nll"]), jm["nll"]) < 1e-5
    jg = jax.tree.map(np.asarray, jg)
    for name, g in zip(names, grads):
        assert _err(_np(g), _leaf(jg, name)) < 1e-5, name
    encdec = cfg.family == "encdec"
    for part in ("encoder.", ".cross.", ".norm_x."):
        assert any(part in n for n in names) == encdec, part


def test_encoder_leaves_decay_as_the_reference_s():
    """The reference stacks the encoder, so every encoder leaf (its norm
    scales too) has more than one dim and is decayed; a decoder block's
    stacked `norm_x` too; `final_norm` is not."""
    _, _, tcfg, model = _models("seamless-m4t-medium")
    named = dict(model.named_parameters())
    assert decays("encoder.1.norm1.scale", named["encoder.1.norm1.scale"])
    assert decays("blocks.0.sub0.norm_x.scale",
                  named["blocks.0.sub0.norm_x.scale"])
    assert not decays("final_norm.scale", named["final_norm.scale"])


# --- weights across the packages -----------------------------------------------

def test_params_from_jax_fills_the_encoder_and_cross_attention():
    cfg, params, tcfg, model = _models("seamless-m4t-medium", seed=10)
    tree = jax.tree.map(np.asarray, params)
    assert len(model.encoder) == cfg.encoder_layers == 2
    for i in range(cfg.encoder_layers):
        assert np.array_equal(_np(model.encoder[i].mix.q.w),
                              tree["encoder"]["mix"]["q"]["w"][i])
        assert np.array_equal(_np(model.encoder[i].ffn.wo.w),
                              tree["encoder"]["ffn"]["wo"]["w"][i])
    for g in range(len(model.blocks)):
        block = model.blocks[g]["sub0"]
        assert np.array_equal(_np(block.cross.k.w),
                              tree["blocks"]["sub0"]["cross"]["k"]["w"][g])
        assert np.array_equal(_np(block.norm_x.scale),
                              tree["blocks"]["sub0"]["norm_x"]["scale"][g])
    names = {n for n, _ in model.named_parameters()}
    assert len(names) == sum(
        len(v) if k[0] in ("blocks", "encoder") else 1
        for k, v in _paths(tree).items())


def _paths(tree, path=()):
    """{leaf path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, path + (str(i),)).items()}
    return {path: tree}


@pytest.mark.parametrize("fault", ["missing cross", "extra encoder layer",
                                   "wrong norm_x"])
def test_params_from_jax_rejects_an_encoder_tree_that_does_not_fit(fault):
    _, params, tcfg, _ = _models("seamless-m4t-medium")
    tree = jax.tree.map(np.asarray, params)
    if fault == "missing cross":
        del tree["blocks"]["sub0"]["cross"]["q"]
        with pytest.raises(KeyError, match="cross.q.w"):
            params_from_jax(tree, tcfg, device="cpu")
    elif fault == "extra encoder layer":
        wo = tree["encoder"]["ffn"]["wo"]
        wo["w"] = np.concatenate([wo["w"], wo["w"][:1]])
        with pytest.raises(KeyError, match="encoder.ffn.wo.w"):
            params_from_jax(tree, tcfg, device="cpu")
    else:
        nx = tree["blocks"]["sub0"]["norm_x"]
        nx["scale"] = nx["scale"][..., :-1]
        with pytest.raises(ValueError, match="norm_x"):
            params_from_jax(tree, tcfg, device="cpu")


# --- the serving entry point -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_a_manual_greedy_loop(arch):
    """`generate` with the model's extra input: a prefill over the prefix
    and tokens into a cache with room for both, or with the source, then
    decode steps that pass the source again."""
    _, _, tcfg, model = _models(arch, seed=11)
    batch = _inputs(tcfg, seed=12)
    gen = 4
    out, prefill_s, decode_ms = serve.generate(
        model, tcfg, batch, gen, prefill_impl="kernel", device="cpu")
    assert out.shape == (B, gen) and out.dtype == torch.int32
    assert prefill_s > 0 and decode_ms > 0
    tb = _t(batch)
    extra = {k: v for k, v in tb.items() if k == "src_embeds"}
    prefix = tcfg.num_prefix if tcfg.frontend else 0
    cache = TTF.init_cache(tcfg, B, max_len=S + gen + prefix, device="cpu")
    tin, mode, want = tb, "prefill", []
    with torch.no_grad():
        for _ in range(gen):
            logits, cache, _ = TTF.forward(model, tcfg, tin, mode,
                                           cache=cache, attn_impl="naive")
            tok = torch.argmax(logits[:, -1:], -1).int()
            want.append(tok)
            tin, mode = {"tokens": tok, **extra}, "decode"
    assert torch.equal(out, torch.cat(want, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"], device="cpu")
    assert out.shape == (2, 3)
    assert f"{arch}-smoke: prefill" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_draw_batch_is_the_reference_command_line_s(arch):
    """The inputs `serve.main` draws: the reference's `main` draws tokens,
    then a vision model's prefix_embeds, then an encoder-decoder's
    src_embeds (at the prompt's length) from `default_rng(0)`, in that
    order, as ``normal * 0.02`` in the model's dtype."""
    cfg = treg.get_config(arch)
    got = serve.draw_batch(cfg, 2, 8)
    rng = np.random.default_rng(0)
    assert np.array_equal(got["tokens"],
                          rng.integers(0, cfg.vocab_size, (2, 8)))
    rows = {"prefix_embeds": cfg.num_prefix, "src_embeds": 8}
    name = "prefix_embeds" if cfg.frontend == "vision" else "src_embeds"
    assert set(got) == {"tokens", name}
    want = rng.normal(size=(2, rows[name], cfg.d_model)) * 0.02
    assert got[name].dtype == cfg.torch_dtype
    assert np.array_equal(_np(got[name]), np.asarray(
        jnp.asarray(want, jnp.bfloat16), np.float32))


# --- the dry-run's stand-in inputs ---------------------------------------------

@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_input_specs_equal_the_reference(arch):
    """Keys, shapes and dtypes of every cell's inputs, as `meta` tensors,
    for every LM shape and a batch override."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    dtypes = {"int32": torch.int32, "bfloat16": torch.bfloat16,
              "float32": torch.float32}
    for shape in jbase.LM_SHAPES:
        for override in (None, 3):
            want = jreg.input_specs(jcfg, shape, override)
            got = treg.input_specs(tcfg, tbase.shape_by_name(shape.name),
                                   override)
            assert list(got) == list(want)
            for k, spec in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == spec.shape, (shape.name, k)
                assert got[k].dtype == dtypes[str(spec.dtype)], (shape.name,
                                                                 k)
