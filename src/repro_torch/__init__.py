"""repro_torch: the PyTorch/CUDA port of the switch-less Dragonfly simulator
and its LM substrate.

A second package beside the JAX reference `repro`.  It mirrors `repro`'s
module paths and public names, imports `torch` and `numpy` only, and runs
its entry points on a CUDA device unless the caller passes
``device="cpu"`` (see `device.resolve_device`).

This module is the ONLY place the port reads environment variables:
every `REPRO_*` knob goes through `env_int` (or `env_raw` for raw
audits, `env_count` for a strict count), as in the reference package.
The reference's XLA flag setup has no meaning here and is not ported:
its `REPRO_HOST_DEVICES=N` (split the host into N devices) is read at
call time by `device.host_devices`, strictly, through `env_count`.
"""
from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """Integer environment knob; unset/empty/non-integer -> `default`."""
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def env_raw(name: str) -> str | None:
    """Raw environment knob string, `None` when unset."""
    return os.environ.get(name)


def env_count(name: str) -> int | None:
    """A strictly parsed count knob (the reference's REPRO_HOST_DEVICES
    parse): `None` when unset or empty; a value that is not an integer,
    or below 1, raises ValueError naming the knob."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        count = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer device count") from None
    if count < 1:
        raise ValueError(f"{name}={count} must be >= 1")
    return count
