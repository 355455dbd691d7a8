"""The LM stack (port of `repro.models.transformer`), for every family of
the registry: dense attention models (full or local attention, dense
SwiGLU FFNs), Mixture-of-Experts models (`moe` FFNs after `first_dense`
dense layers), Mamba-2 SSD models (`ssm` blocks), Griffin hybrids
(`rglru` and local-attention blocks), models with a modality prefix
(``prefix_embeds`` before the tokens) and encoder-decoder models (an
encoder of non-causal ``enc`` blocks over ``src_embeds``, whose output
every decoder block reads through a cross-attention).

The reference groups layers into repeating "pattern" super-blocks and
scans them; here the groups are an `nn.ModuleList` looped over in Python,
each group an `nn.ModuleDict` of sub-blocks ``sub0 ... sub{P-1}``.
Parameter names mirror the reference's tree (``blocks.<g>.sub<j>.mix.q.w``
is the reference's ``blocks.sub<j>.mix.q.w[g]``, ``encoder.<i>.mix.q.w``
its ``encoder.mix.q.w[i]``).

`constrain` is the reference's sharding hook, called where the reference
calls it (`runtime.sharding.make_constrain`): on DTensors it redistributes
the residual stream, the gathered final activations and the logits to the
reference's specs; the default, and any call on a plain tensor, is the
identity.

Modes:
  train    - full sequence, loss-ready logits (with `remat`, each group is
             recomputed in the backward pass, `torch.utils.checkpoint`)
  prefill  - full sequence + populates the KV / state caches
  decode   - single token step against the caches

`attn_impl` picks the attention implementation (`layers.attention_apply`)
and, where the reference has no such choice, the sequence scans: with
"kernel" the `ssm` blocks' chunked SSD and the `rglru` blocks' LRU scan
run their kernels (`kernels.ssd_scan`, `kernels.rglru`), which compute
the same functions as the plain torch forms every other value runs, as
the reference always does.  The single-token decode step is the exact
recurrence either way.

Caches are updated in place: `forward` writes each layer's new keys,
values, `idx` and `base`, or conv window and state, into the `cache` it
was given and returns it.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .layers import AttnConfig
from .moe import MoE, moe_apply
from .placement import grad_as_value, is_dt, like, local, reduced
from .rglru import RGLRU, rglru_apply, rglru_cache_init
from .ssm import SSM, ssm_apply, ssm_cache_init


def _attn_cfg(cfg: ModelConfig, impl: str, kind: str) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        use_bias=cfg.use_bias, rope_theta=cfg.rope_theta,
        rope_frac=cfg.rope_frac, causal=(kind != "enc"),
        window=(cfg.local_window or None) if kind == "local" else None,
        attn_impl=impl)


def _layer_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.block_pattern[i % len(cfg.block_pattern)]


def _ffn_kind(cfg: ModelConfig, i: int) -> str:
    if cfg.moe is not None and i >= cfg.first_dense:
        return "moe"
    return "dense" if cfg.d_ff else "none"


# --- single sub-block --------------------------------------------------------

class Block(nn.Module):
    """One pre-norm sub-block: the mixer of its kind (attention, SSM or
    RG-LRU), with `cross` a cross-attention to the encoder's output, then
    the FFN, dense or MoE (`_sub_init`)."""

    def __init__(self, cfg: ModelConfig, kind: str, ffn: str, device=None,
                 cross: bool = False):
        super().__init__()
        dtype = cfg.torch_dtype
        self.norm1 = L.RMSNorm(cfg.d_model, device)
        if kind in ("attn", "local", "enc"):
            self.mix = L.Attention(_attn_cfg(cfg, "naive", kind), dtype,
                                   device)
        elif kind == "rglru":
            self.mix = RGLRU(cfg.d_model, cfg.rglru, dtype, device)
        elif kind == "ssm":
            self.mix = SSM(cfg.d_model, cfg.ssm, dtype, device)
        else:
            raise ValueError(kind)
        if cross:
            self.norm_x = L.RMSNorm(cfg.d_model, device)
            self.cross = L.Attention(_attn_cfg(cfg, "naive", "enc"), dtype,
                                     device)
        else:
            self.norm_x = self.cross = None
        if ffn == "dense":
            self.norm2 = L.RMSNorm(cfg.d_model, device)
            self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, dtype, cfg.use_bias,
                                device)
        elif ffn == "moe":
            self.norm2 = L.RMSNorm(cfg.d_model, device)
            self.ffn = MoE(cfg.d_model, cfg.moe, dtype, device)
        else:
            self.norm2 = self.ffn = None


def _sub_apply(p: Block, cfg: ModelConfig, kind: str, ffn: str, impl: str,
               x, positions, inv_freq, cache, memory=None):
    """One sub-block: (x, aux loss), the aux loss an fp32 scalar tensor
    from an MoE FFN and None otherwise.  A block with a cross-attention
    reads `memory` [B, Sm, D] (the encoder's output) through it, on the
    naive path, as the reference routes every cross-attention."""
    h = L.rmsnorm(p.norm1, x, cfg.norm_eps)
    acfg = _attn_cfg(cfg, impl, kind)
    aux = None
    if kind in ("attn", "local", "enc"):
        mixed, _ = L.attention_apply(p.mix, acfg, h, positions, inv_freq,
                                     cache)
    elif kind == "rglru":
        mixed, _ = rglru_apply(p.mix, h, cfg.rglru, cache,
                               use_kernel=impl == "kernel")
    else:
        mixed, _ = ssm_apply(p.mix, h, cfg.ssm, cfg.d_model, cache,
                             use_kernel=impl == "kernel")
    x = x + mixed
    if p.cross is not None and memory is not None:
        hx = L.rmsnorm(p.norm_x, x, cfg.norm_eps)
        xa, _ = L.attention_apply(p.cross, acfg, hx, positions, inv_freq,
                                  None, kv_memory=memory)
        x = x + xa
    if ffn == "dense":
        h2 = L.rmsnorm(p.norm2, x, cfg.norm_eps)
        x = x + L.swiglu(p.ffn, h2)
    elif ffn == "moe":
        h2 = L.rmsnorm(p.norm2, x, cfg.norm_eps)
        y, aux = moe_apply(p.ffn, h2, cfg.moe)
        x = x + y
    return x, aux


def _sub_cache_init(cfg: ModelConfig, kind: str, batch, max_len, dtype,
                    device, lead=()):
    if kind == "rglru":
        return rglru_cache_init(batch, cfg.d_model, cfg.rglru, dtype, device,
                                lead)
    if kind == "ssm":
        return ssm_cache_init(batch, cfg.d_model, cfg.ssm, dtype, device,
                              lead)
    W = min(cfg.local_window, max_len) if kind == "local" \
        and cfg.local_window else max_len
    shape = (*lead, batch, W, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": torch.zeros(lead, dtype=torch.int32, device=device),
            "base": torch.zeros(lead, dtype=torch.int32, device=device)}


# --- model -------------------------------------------------------------------

def _segments(cfg: ModelConfig):
    """(prelude_idx, scanned group count, pattern len, postlude_idx)."""
    P = len(cfg.block_pattern)
    pre = list(range(cfg.first_dense))
    rest = cfg.num_layers - cfg.first_dense
    groups = rest // P
    post = list(range(cfg.first_dense + groups * P, cfg.num_layers))
    return pre, groups, P, post


class Transformer(nn.Module):
    """The model's weights, laid out as the reference's param tree.  Built
    with uninitialised weights; `init_params` draws them and
    `convert.params_from_jax` copies them from the reference."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        pre, groups, P, post = _segments(cfg)
        cross = cfg.encoder_layers > 0

        def block(i):
            return Block(cfg, _layer_kind(cfg, i), _ffn_kind(cfg, i), device,
                         cross)

        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=cfg.torch_dtype, device=device))
        self.prelude = nn.ModuleList([block(i) for i in pre])
        self.blocks = nn.ModuleList([
            nn.ModuleDict({f"sub{j}": block(cfg.first_dense + j)
                           for j in range(P)}) for _ in range(groups)])
        self.postlude = nn.ModuleList([block(i) for i in post])
        self.encoder = nn.ModuleList([
            Block(cfg, "enc", "dense", device)
            for _ in range(cfg.encoder_layers)])
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, dtype=cfg.torch_dtype,
                        device=device))


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """A model with random weights, drawn by `generator` (on its own
    device) and placed on `device` (CUDA unless the caller passes
    ``device="cpu"``).  Embeddings are truncated normal of std 1, dense
    weights of std 1/sqrt(d_in), an untied head of std 1/sqrt(d_model),
    the SSM, RG-LRU and MoE blocks' other weights as their `reset` says, as
    in the reference; the numbers differ from the reference's, whose
    generator is JAX's."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    with torch.no_grad():
        model.embed.copy_(L.truncated_normal(
            generator, model.embed.shape, model.embed.dtype, 1.0))
        for module in model.modules():
            if isinstance(module, (L.Dense, SSM, RGLRU, MoE)):
                module.reset(generator)
        if model.lm_head is not None:
            model.lm_head.copy_(L.truncated_normal(
                generator, model.lm_head.shape, model.lm_head.dtype,
                cfg.d_model ** -0.5))
    return model


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed KV / state caches in the reference's layout: ``prelude`` /
    ``postlude`` lists of per-layer dicts and ``blocks.sub<j>`` dicts
    stacked over the groups."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    pre, groups, P, post = _segments(cfg)
    cache = {"prelude": [
        _sub_cache_init(cfg, _layer_kind(cfg, i), batch, max_len, dtype,
                        device) for i in pre]}
    if groups:
        cache["blocks"] = {
            f"sub{j}": _sub_cache_init(
                cfg, _layer_kind(cfg, cfg.first_dense + j), batch, max_len,
                dtype, device, lead=(groups,))
            for j in range(P)}
    cache["postlude"] = [
        _sub_cache_init(cfg, _layer_kind(cfg, i), batch, max_len, dtype,
                        device) for i in post]
    return cache


def _identity(x, kind: str = "resid"):
    return x


def forward(params: Transformer, cfg: ModelConfig, batch: dict,
            mode: str = "train", cache=None, attn_impl: str = "chunked",
            remat: bool = True, constrain=None):
    """batch: tokens [B, S_tok], with a frontend ``prefix_embeds`` [B, P, D]
    (placed before the tokens' embeddings; the logits cover only the
    tokens outside decode), with an encoder ``src_embeds`` [B, Sm, D]
    (encoded at positions 0..Sm-1 with `attn_impl`) or the encoder's
    output ``memory`` [B, Sm, D].  Returns (logits, cache, aux_loss);
    `cache` (prefill, decode) is updated in place and returned.  The aux
    loss is the fp32 sum of the MoE FFNs' load-balance losses (0 without
    MoE).  With `remat` in train mode, each scanned group's activations
    are recomputed in the backward pass, as the reference's
    `jax.checkpoint` of its scan body (only where autograd records).
    `constrain(x, kind)` is applied where the reference applies it."""
    dtype = cfg.torch_dtype
    constrain = constrain or _identity
    tokens = batch["tokens"]
    S_tok = tokens.shape[1]
    x = _embed(params.embed, tokens)
    prefixed = bool(cfg.frontend) and "prefix_embeds" in batch
    if prefixed:
        x = torch.cat([batch["prefix_embeds"].to(dtype), x], dim=1)
    x = constrain(x)
    B, S, D = x.shape
    dev = x.device
    if mode == "decode":
        # positions from the first attention cache idx (all layers agree)
        idx = _first_idx(cache)
        positions = idx + like(idx, torch.arange(
            S, device=dev))[None, :].repeat(B, 1)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev)[None, :].repeat(B, 1)
    inv_freq = L.rope_freqs(cfg.hd, cfg.rope_theta,
                            rot_dim=int(cfg.hd * cfg.rope_frac), device=dev)
    positions, inv_freq = like(x, positions), like(x, inv_freq)
    use_cache = cache is not None
    aux_total = like(x, torch.zeros((), dtype=torch.float32, device=dev))

    memory = batch.get("memory")
    if cfg.encoder_layers and memory is None and "src_embeds" in batch:
        memory = batch["src_embeds"].to(dtype)
        mpos = like(memory, torch.arange(
            memory.shape[1], dtype=torch.int32,
            device=dev)[None, :].repeat(B, 1))
        for p in params.encoder:
            memory, _ = _sub_apply(p, cfg, "enc", "dense", attn_impl, memory,
                                   mpos, like(memory, inv_freq), None)
            memory = constrain(memory)

    def run_sub(p, i, x, c):
        return _sub_apply(p, cfg, _layer_kind(cfg, i), _ffn_kind(cfg, i),
                          attn_impl, x, positions, inv_freq, c, memory)

    def add(total, aux):
        return total if aux is None else total + aux

    def run_listed(part, idxs, x, aux_total):
        for j, i in enumerate(idxs):
            c = cache[part][j] if use_cache else None
            x, aux = run_sub(getattr(params, part)[j], i, x, c)
            x = constrain(x)
            aux_total = add(aux_total, aux)
        return x, aux_total

    def run_group(g, x, aux_total):
        for j in range(P):
            sub = f"sub{j}"
            # views of group g: the layer's in-place updates land in the stack
            c = ({name: t[g] for name, t in cache["blocks"][sub].items()}
                 if use_cache else None)
            x, aux = run_sub(params.blocks[g][sub], cfg.first_dense + j, x, c)
            x = constrain(x)
            aux_total = add(aux_total, aux)
        return x, aux_total

    pre, groups, P, post = _segments(cfg)
    x, aux_total = run_listed("prelude", pre, x, aux_total)
    recompute = remat and mode == "train" and torch.is_grad_enabled()
    for g in range(groups):
        if recompute:
            x, aux_total = checkpoint(run_group, g, x, aux_total,
                                      use_reentrant=False)
        else:
            x, aux_total = run_group(g, x, aux_total)
    x, aux_total = run_listed("postlude", post, x, aux_total)

    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if prefixed and mode != "decode":
        x = x[:, -S_tok:]   # logits only over the token positions
    x = constrain(x, "gather")  # un-shard seq before the vocab matmul
    head = grad_as_value(params.embed).T if cfg.tie_embeddings \
        else params.lm_head
    logits = constrain(x @ head, "logits")
    return logits, cache, aux_total


def _embed(table, tokens):
    """table[tokens].  On DTensors the lookup runs on each rank's shard
    (`placement.local`): a vocab shard looks up the tokens in its rows and
    adds zeros for the rest (a partial sum over the vocab shards, reduced
    here), an FSDP shard of the table is gathered, the tokens keep their
    batch shard; with no vocab shard it is the plain lookup."""
    if not is_dt(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    table = grad_as_value(table)
    tokens = like(table, tokens)
    mesh = table.device_mesh
    n, lo = table.shape[0], 0
    tbl_pl, tok_pl, out_pl, grad_pl = [], [], [], []
    for i, (p, q) in enumerate(zip(table.placements, tokens.placements)):
        size = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 0 and size > 1:
            n //= size
            lo += mesh.get_local_rank(i) * n
            tbl_pl.append(Shard(0))
            tok_pl.append(Replicate())
            out_pl.append(Partial())
            grad_pl.append(Shard(0))
        else:
            q = q if isinstance(q, Shard) else Replicate()
            tbl_pl.append(Replicate())
            tok_pl.append(q)
            out_pl.append(q)
            grad_pl.append(Partial() if isinstance(q, Shard) else Replicate())
    vocab_split = n < table.shape[0]

    def look(tbl, tok):
        if not vocab_split:
            return (tbl[tok],)
        t = tok - lo
        ok = (t >= 0) & (t < n)
        return (tbl[torch.where(ok, t, 0)] * ok[..., None].to(tbl.dtype),)

    x, = local(look, (tuple(out_pl),), (tuple(tbl_pl), tuple(tok_pl)),
               table, tokens,
               in_grad_placements=(tuple(grad_pl), tuple(tok_pl)))
    return reduced(x)


def _label_logits(lg, labels):
    """lg[b, s, labels[b, s]].  On DTensors the gather runs on each rank's
    shard: a vocab shard reads the labels in its columns and adds zeros
    for the rest (a partial sum over the vocab shards, reduced here); with
    no vocab shard it is the plain gather."""
    if not is_dt(lg):
        return lg.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    labels = like(lg, labels)
    mesh = lg.device_mesh
    n, lo = lg.shape[-1], 0
    lg_pl, lab_pl, out_pl = [], [], []
    split = 1
    for i, p in enumerate(lg.placements):
        size = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 2 and size > 1:
            n //= size
            lo += mesh.get_local_rank(i) * n
            lg_pl.append(Shard(2))
            lab_pl.append(Replicate())
            out_pl.append(Partial())
        elif isinstance(p, Shard) and p.dim == 0 \
                and lg.shape[0] % (split * size) == 0:
            split *= size
            lg_pl.append(Shard(0))
            lab_pl.append(Shard(0))
            out_pl.append(Shard(0))
        else:
            lg_pl.append(Replicate())
            lab_pl.append(Replicate())
            out_pl.append(Replicate())
    vocab_split = n < lg.shape[-1]

    def pick(lg, lab):
        if not vocab_split:
            return (lg.gather(-1, lab[..., None])[..., 0],)
        t = lab - lo
        ok = (t >= 0) & (t < n)
        got = lg.gather(-1, torch.where(ok, t, 0)[..., None])[..., 0]
        return (got * ok.to(got.dtype),)

    ll, = local(pick, (tuple(out_pl),), (tuple(lg_pl), tuple(lab_pl)),
                lg, labels,
                in_grad_placements=(tuple(lg_pl), tuple(lab_pl)))
    return reduced(ll)


def lm_loss(params: Transformer, cfg: ModelConfig, batch: dict,
            attn_impl: str = "chunked", remat: bool = True, constrain=None):
    """Mean next-token cross entropy over the positions with a label >= 0,
    plus the MoE aux loss: (loss, {"nll", "aux"}), fp32 scalars.  The
    log-sum-exp is the reference's, max-shifted in fp32."""
    logits, _, aux = forward(params, cfg, batch, "train",
                             attn_impl=attn_impl, remat=remat,
                             constrain=constrain)
    labels = batch["labels"]
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
    ll = _label_logits(lg, torch.clamp(labels, min=0).long())
    mask = (labels >= 0).float()
    nll = ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux, {"nll": nll, "aux": aux}


def _first_idx(cache):
    for part in ("prelude", "postlude"):
        for c in cache[part]:
            if "idx" in c:
                return c["idx"]
    if "blocks" in cache:
        for j in range(16):
            sub = cache["blocks"].get(f"sub{j}")
            if sub is None:
                break
            if "idx" in sub:
                return sub["idx"][0]
    # no attention layer (positions are unused): a zero on the cache's
    # device
    caches = cache["prelude"] + cache["postlude"] \
        + list(cache.get("blocks", {}).values())
    device = next(iter(caches[0].values())).device
    return torch.zeros((), dtype=torch.int32, device=device)
