"""Model / run configuration dataclasses (port of `repro.configs.base`).

A copy of the reference module; `ModelConfig.jdtype` becomes the
`torch_dtype` property."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # expert dispatch payload: "bf16" or "int8" (per-token-scaled
    # quantization of the all-to-all, beyond-paper perf lever)
    dispatch: str = "bf16"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0               # 0 -> d_model
    d_conv: int = 4
    c: float = 8.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # attention
    rope_theta: float = 1e4
    rope_frac: float = 1.0       # chatglm "2d" RoPE rotates half the dims
    use_bias: bool = False
    tie_embeddings: bool = False
    local_window: int = 0        # 0 = full attention
    # per-layer block kinds, cycled over the depth: "attn" | "rglru" | "ssm"
    block_pattern: tuple = ("attn",)
    # FFN kind per layer: "dense" everywhere unless moe is set; the first
    # `first_dense` layers stay dense (DeepSeekMoE)
    moe: MoEConfig | None = None
    first_dense: int = 0
    # SSM / hybrid
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: number of prefix embeddings in input_specs
    frontend: str | None = None      # "vision" | "audio"
    num_prefix: int = 0
    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # schedule hint (minicpm -> wsd)
    schedule: str = "cosine"
    # whether long_500k applies (sub-quadratic sequence mixing)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    def num_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        enc = self.encoder_layers
        for i in range(L + enc):
            kind = self.block_pattern[i % len(self.block_pattern)] \
                if i < L else "attn"
            if kind in ("attn", "local", "enc"):
                attn = d * self.hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * self.hd * d
            elif kind == "rglru":
                r = self.rglru.d_rnn or d
                attn = 2 * d * r + r * d + 3 * r
            else:  # ssm
                s = self.ssm
                di = s.d_inner(d)
                attn = d * (2 * di + 2 * s.d_state + s.num_heads(d)) + di * d
            if self.moe is not None and i >= self.first_dense and i < L:
                e = self.moe
                ffp = e.num_experts * 3 * d * e.d_expert \
                    + e.num_shared * 3 * d * e.d_expert + d * e.num_experts
            else:
                ffp = 3 * d * ff if ff else 0
            total += attn + ffp
        if enc and i >= L:
            pass
        return total

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed top-k)."""
        if self.moe is None:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        e = self.moe
        full = self.num_params()
        all_expert = (L - self.first_dense) * e.num_experts * 3 * d * e.d_expert
        active_expert = (L - self.first_dense) * e.top_k * 3 * d * e.d_expert
        return full - all_expert + active_expert


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        num_layers=min(cfg.num_layers, 2 * len(cfg.block_pattern)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        num_prefix=min(cfg.num_prefix, 4),
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=32,
            num_shared=min(cfg.moe.num_shared, 1))
        kw["first_dense"] = min(cfg.first_dense, 1)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                        chunk=16)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(cfg.rglru, d_rnn=64)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
