"""Batched serving driver on the PyTorch/CUDA port: prefill + greedy
decode with KV/state caches over batched requests, at an architecture's
`-smoke` config with seeded random weights and `attn_impl="naive"` (the
port of `examples/serve_lm.py`).

Run from the repo root (after `pip install -e .`, or `PYTHONPATH=src`):

    python -m examples.torch_serve_lm --arch recurrentgemma-2b   # on the GPU
    python -m examples.torch_serve_lm --device cpu
"""
import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import draw_batch, generate
from repro_torch.models import transformer as TF


def serve(model, cfg, batch: int, prompt_len: int, gen: int, device):
    """The reference script's requests on `model` (on `device`): `batch`
    prompts of `prompt_len` tokens (plus a vision model's prefix rows or
    an encoder-decoder's source frames) drawn from
    ``np.random.default_rng(0)``, a naive prefill, then `gen` greedy
    tokens.  Returns (tokens [batch, gen] int32 on the device, prefill
    seconds, decode ms per token)."""
    return generate(model, cfg, draw_batch(cfg, batch, prompt_len), gen,
                    prefill_impl="naive", device=device)


def main(argv=None, device=None):
    """The reference script's command line, on `device` (the `--device`
    flag; CUDA when neither names one).  Returns the generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or device)

    cfg = get_config(args.arch + "-smoke")
    model = TF.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    B, S = args.batch, args.prompt_len
    gen, t_pref, dec_ms = serve(model, cfg, B, S, args.gen, dev)
    print(f"arch={cfg.name}  batch={B}  prompt={S}  gen={args.gen}")
    print(f"prefill: {t_pref * 1e3:.1f} ms   decode: {dec_ms:.1f} ms/token")
    print("generated token ids (first request):",
          gen[0, :12].cpu().numpy(), "...")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise RuntimeError("generated a token outside the vocabulary")
    print("OK")
    return gen


if __name__ == "__main__":
    main()
