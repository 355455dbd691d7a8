"""Serving launcher (port of `repro.launch.serve`): --arch <id>, batched
prefill + greedy decode against KV and state caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --prompt-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi-3-vision-4.2b --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-medium --prompt-len 2048

Prefill runs the kernels (`attn_impl="kernel"`): attention layers the
flash-attention kernel, where the reference runs its portable
online-softmax stand-in ("chunked"), and `ssm` / `rglru` layers the SSD
and RG-LRU scan kernels, where the reference runs its plain chunked and
associative scans; each pair computes the same function.  `--smoke`
keeps "naive", as the reference does.  Decode runs the layers' exact
single-token branches (`attn_impl="naive"`).

A vision model's prompt is its ``prefix_embeds`` (the stub of an image
encoder's patch embeddings) then its tokens, all in the cache.  An
encoder-decoder model's ``src_embeds`` (the stub of a speech frontend's
frames) go to the prefill and again to every decode step, which
re-encodes them (naive), as the reference's serve loop does.  `main`
draws both at random, as the reference's command line does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import ARCHS, get_config
from ..device import resolve_device
from ..models import transformer as TF


def cache_len(cfg, S, gen):
    """The cache slots for a prompt of S tokens and `gen` more: a
    frontend's prefix rows are in the cache too."""
    return S + gen + (cfg.num_prefix if cfg.frontend else 0)


def decode_extra(cfg, batch):
    """What a decode step passes besides its token: an encoder-decoder's
    ``src_embeds``, which the step encodes again (the reference's serve
    loop keeps no encoder memory)."""
    return {"src_embeds": batch["src_embeds"]} \
        if cfg.encoder_layers and "src_embeds" in batch else {}


def generate(model, cfg, batch, gen, *, prefill_impl, device=None):
    """Greedy generation of `gen` tokens after a batched prefill of
    ``batch["tokens"]`` [B, S] (after ``batch["prefix_embeds"]`` [B, P, D]
    with a frontend; with an encoder, ``batch["src_embeds"]`` [B, Sm, D]
    go to the prefill and to every decode step).  Returns (tokens
    [B, gen] int32 on the device, prefill seconds, decode ms per token).
    The device is synchronised before each clock is read."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"generate: the model is not on {device}")
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.int32).to(device)
    B, S = tokens.shape
    prompt = {"tokens": tokens}
    for name in ("prefix_embeds", "src_embeds"):
        if name in batch:
            prompt[name] = torch.as_tensor(batch[name]).to(device)
    extra = decode_extra(cfg, prompt)
    cache = TF.init_cache(cfg, B, max_len=cache_len(cfg, S, gen),
                          device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache, _ = TF.forward(model, cfg, prompt, "prefill",
                                      cache=cache, attn_impl=prefill_impl)
        tok = torch.argmax(logits[:, -1:], dim=-1).int()
        sync()
        t_pref = time.perf_counter() - t0
        toks = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache, _ = TF.forward(model, cfg,
                                          {"tokens": tok, **extra}, "decode",
                                          cache=cache, attn_impl="naive")
            tok = torch.argmax(logits[:, -1:], dim=-1).int()
            toks.append(tok)
        sync()
        t_dec = time.perf_counter() - t0
    return torch.cat(toks, dim=1), t_pref, t_dec / max(gen - 1, 1) * 1e3


def draw_batch(cfg, B, S, seed=0):
    """The reference command line's inputs, drawn from
    ``np.random.default_rng(seed)`` in its order: tokens [B, S], then
    with a vision frontend ``prefix_embeds`` [B, num_prefix, D], then for
    an encoder-decoder ``src_embeds`` [B, S, D], both ``normal * 0.02``
    (numpy float64 then the model's dtype, as tensors on the CPU)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    for name, rows, wanted in (
            ("prefix_embeds", cfg.num_prefix, cfg.frontend == "vision"),
            ("src_embeds", S, cfg.family == "encdec")):
        if wanted:
            batch[name] = torch.from_numpy(
                rng.normal(size=(B, rows, cfg.d_model)) * 0.02).to(
                cfg.torch_dtype)
    return batch


def main(argv=None, device=None):
    """The reference's command line.  Runs on CUDA unless `device` says
    otherwise; returns the generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)

    device = resolve_device(device)
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    model = TF.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    batch = draw_batch(cfg, args.batch, args.prompt_len)
    impl = "naive" if args.smoke else "kernel"
    out, t_pref, dec_ms = generate(model, cfg, batch, args.gen,
                                   prefill_impl=impl, device=device)
    print(f"{cfg.name}: prefill {t_pref * 1e3:.1f} ms, decode "
          f"{dec_ms:.1f} ms/token")
    print("tokens[0]:", out[0, :12].tolist())
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError("generated a token outside the vocabulary")
    return out


if __name__ == "__main__":
    main()
