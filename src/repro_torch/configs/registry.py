"""The 10 assigned architectures, exact public-literature configs (port of
`repro.configs.registry`).

Every entry is selectable via --arch <id>; `input_specs` produces
stand-ins on the `meta` device for the dry-run (no allocation).
"""
from __future__ import annotations

import torch

from .base import (LM_SHAPES, MoEConfig, ModelConfig, RGLRUConfig,
                   ShapeConfig, SSMConfig, shape_by_name, smoke_config)


def _pad_vocab(v: int, mult: int = 256) -> int:
    """Pad vocab to a multiple of 256 so the embedding/logits shard across
    the 16-way model axis (Megatron-style vocab padding).  The true vocab
    sizes are documented per-arch; padding adds <0.6% parameters."""
    return ((v + mult - 1) // mult) * mult


def minicpm_2b() -> ModelConfig:
    # [arXiv:2404.06395] 40L d=2304 36H (kv=36) ff=5760 V=122753, WSD sched
    return ModelConfig(
        name="minicpm-2b", family="dense", num_layers=40, d_model=2304,
        num_heads=36, num_kv_heads=36, d_ff=5760,
        vocab_size=_pad_vocab(122753),
        tie_embeddings=True, schedule="wsd")


def chatglm3_6b() -> ModelConfig:
    # [arXiv:2406.12793] 28L d=4096 32H (kv=2) ff=13696 V=65024, 2D RoPE
    return ModelConfig(
        name="chatglm3-6b", family="dense", num_layers=28, d_model=4096,
        num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=_pad_vocab(65024),
        rope_frac=0.5, use_bias=False)


def llama32_3b() -> ModelConfig:
    # [hf:meta-llama/Llama-3.2] 28L d=3072 24H (kv=8) ff=8192 V=128256
    return ModelConfig(
        name="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
        num_heads=24, num_kv_heads=8, d_ff=8192, vocab_size=_pad_vocab(128256),
        rope_theta=5e5, tie_embeddings=True)


def command_r_35b() -> ModelConfig:
    # [hf:CohereForAI/c4ai-command-r-v01] 40L d=8192 64H (kv=8) ff=22528
    return ModelConfig(
        name="command-r-35b", family="dense", num_layers=40, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=22528, vocab_size=_pad_vocab(256000),
        use_bias=False, rope_theta=8e6)


def mamba2_780m() -> ModelConfig:
    # [arXiv:2405.21060] 48L d=1536 attn-free, ssm_state=128
    return ModelConfig(
        name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=_pad_vocab(50280),
        head_dim=64, block_pattern=("ssm",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk=128),
        subquadratic=True)


def phi3_vision_4b() -> ModelConfig:
    # [hf:microsoft/Phi-3-vision-128k-instruct] 32L d=3072 32H ff=8192
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
        num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=_pad_vocab(32064),
        frontend="vision", num_prefix=576)  # 24x24 CLIP patch stub


def deepseek_moe_16b() -> ModelConfig:
    # [arXiv:2401.06066] 28L d=2048 16H ff_expert=1408, 2 shared + 64
    # routed top-6, first layer dense (d_ff = 4*2048 = 8192... the public
    # config uses 10944 for the dense layer; we keep 4d)
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=8192, vocab_size=_pad_vocab(102400),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
        first_dense=1)


def qwen3_moe_235b() -> ModelConfig:
    # [hf:Qwen/Qwen3 family] 94L d=4096 64H (kv=4) ff_expert=1536,
    # 128 experts top-8
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", num_layers=94,
        d_model=4096, num_heads=64, num_kv_heads=4, d_ff=0,
        vocab_size=_pad_vocab(151936), head_dim=128,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536))


def seamless_m4t_medium() -> ModelConfig:
    # [arXiv:2308.11596] enc-dec 12L+12L d=1024 16H ff=4096 V=256206
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec", num_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
        vocab_size=_pad_vocab(256206), encoder_layers=12, frontend="audio",
        num_prefix=0)


def recurrentgemma_2b() -> ModelConfig:
    # [arXiv:2402.19427] 26L d=2560 10H (kv=1) ff=7680, RG-LRU + local
    # attention 1:2 (pattern rglru, rglru, local-attn), window 2048
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26,
        d_model=2560, num_heads=10, num_kv_heads=1, d_ff=7680,
        vocab_size=_pad_vocab(256000), head_dim=256, local_window=2048,
        block_pattern=("rglru", "rglru", "local"),
        rglru=RGLRUConfig(d_rnn=2560, d_conv=4),
        tie_embeddings=True, subquadratic=True)


ARCHS = {
    c.name: f for f, c in
    [(f, f()) for f in (minicpm_2b, chatglm3_6b, llama32_3b, command_r_35b,
                        mamba2_780m, phi3_vision_4b, deepseek_moe_16b,
                        qwen3_moe_235b, seamless_m4t_medium,
                        recurrentgemma_2b)]
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_config(get_config(name[:-len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]()


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell applies (DESIGN.md Sec. 4)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: O(L^2) at 512K not deployable"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: int | None = None) -> dict:
    """Stand-ins for every model input of this cell: tensors on the `meta`
    device with the reference's shapes and dtypes (int32 tokens and
    labels, embeddings in the model's dtype)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def spec(size, dtype=cfg.torch_dtype):
        return torch.empty(size, dtype=dtype, device="meta")

    if shape.kind not in ("train", "prefill"):
        # decode: one new token against a seq_len cache
        specs = {"tokens": spec((B, 1), torch.int32)}
        if cfg.family == "encdec":
            specs["memory"] = spec((B, S // 4, cfg.d_model))
        return specs
    specs = {"tokens": spec((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = spec((B, S), torch.int32)
    if cfg.frontend == "vision":
        specs["prefix_embeds"] = spec((B, cfg.num_prefix, cfg.d_model))
    if cfg.family == "encdec":
        # audio frames ~4x shorter than the token sequence
        specs["src_embeds"] = spec((B, S // 4, cfg.d_model))
    return specs
