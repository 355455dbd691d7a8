"""Provenance records for the port's experiment artifacts: port of
`repro.exp.provenance`.

`git_revision` and `spec_hash` are the reference's (the hash of a spec
agrees across the two packages); `provenance()` records the PyTorch and
CUDA versions, the backend and the device's name in place of JAX's
version, backend and platform.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform as _platform
import subprocess

import torch


def git_revision(repo_dir: str | None = None) -> tuple:
    """`(rev, dirty)`: the current git commit and whether the tree has
    local edits (a separate boolean, so `rev` stays a parseable 40-hex
    revision).  `('unknown', False)` outside a git checkout."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir, check=True,
            capture_output=True, text=True, timeout=10).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=repo_dir, check=True,
            capture_output=True, text=True, timeout=10).stdout.strip()
        return rev, bool(dirty)
    except Exception:
        return "unknown", False


def spec_hash(spec) -> str:
    """SHA-256 of the canonical (sorted-key) JSON form of an
    `ExperimentSpec` — stable across processes, field order and the two
    packages."""
    payload = json.dumps(spec.to_dict(), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


def provenance(spec=None, device=None) -> dict:
    """The provenance block of an artifact.  `device` is the device the
    run used (default: CUDA when there is one, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    rev, dirty = git_revision()
    cuda = device.type == "cuda"
    out = dict(
        git_rev=rev,
        dirty=dirty,
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        backend=device.type,
        platform="gpu" if cuda else "cpu",
        device_name=(torch.cuda.get_device_name(device) if cuda
                     else _platform.processor() or _platform.machine()),
    )
    if spec is not None:
        out["spec_sha256"] = spec_hash(spec)
    return out
