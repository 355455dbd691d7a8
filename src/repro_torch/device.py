"""The port's device rule, shared by the simulator and the LM stack, and
the device list a simulator run may spread over."""
from __future__ import annotations

import torch

from . import env_count


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: `device` when given, else
    CUDA.  Raises when CUDA is absent and the caller did not ask for the
    CPU — the port never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    return torch.device("cuda")


def host_devices(device=None) -> list:
    """The devices one run bound to `device` may spread its lanes over
    (the reference's `jax.devices()`), in order:

    - on CUDA, every visible card (``cuda:0``, ``cuda:1``, ...);
    - on the CPU, one device (`device` itself);
    - with REPRO_HOST_DEVICES=N (the reference's "split the host into N
      devices"), N LOGICAL devices ``cpu:0 .. cpu:N-1`` or ``cuda:0 ..
      cuda:N-1``, logical device i on card ``i % cards``
      (`physical_device`): on one card they share it.

    `device=None` asks about the default device (CUDA when there is one,
    else the CPU); this is a query and runs nothing.  The knob is parsed
    strictly (`env_count`): a non-integer or a value below 1 raises."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    n = env_count("REPRO_HOST_DEVICES")
    if dev.type == "cuda":
        count = n if n is not None else torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(count)]
    if dev.type == "cpu" and n is not None and n > 1:
        return [torch.device("cpu", i) for i in range(n)]
    return [dev]


def physical_device(device) -> torch.device:
    """The device that holds the tensors of (logical) `device`: the CPU for
    every ``cpu:i``, card ``i % cards`` for ``cuda:i`` (the current card
    for ``cuda``).  Tensors report their physical device, so code that
    compares a tensor's device with a logical one compares this."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda":
        if dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda",
                            dev.index % max(torch.cuda.device_count(), 1))
    return dev
