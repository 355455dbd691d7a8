"""Checkpointing: atomic on-disk snapshots of a state tree (port of the
snapshot part of `repro.checkpoint.checkpointing`; resharding onto a
mesh is not ported).

A state tree is nested dicts, lists/tuples and dataclasses (`SimState`)
with numpy arrays, torch tensors or Python scalars at the leaves.  Format:
one .npz per snapshot with flattened "path/to/leaf -> array" keys + a
small JSON manifest; writes go to a temp dir then rename (atomic), and a
retention policy keeps the newest K snapshots.  numpy has no bfloat16, so
a bf16 tensor is saved as its 16-bit pattern (int16) and restored into a
bf16 tensor, bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _children(tree) -> list | None:
    """(name, child) pairs of an inner node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _host_dtype(leaf) -> np.dtype:
    """The dtype `_host(leaf)` has, without fetching the leaf."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.int16 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": host array} over the leaves of `tree`."""
    kids = _children(tree)
    if kids is None:
        return {prefix: _host(tree)}
    out = {}
    for name, child in kids:
        out.update(_flatten(child, f"{prefix}/{name}" if prefix else name))
    return out


def _to_host(tree):
    """`tree` with every leaf fetched to a host array (same structure)."""
    kids = _children(tree)
    if kids is None:
        return _host(tree)
    vals = {name: _to_host(child) for name, child in kids}
    return _rebuild(tree, vals)


def _rebuild(tree, vals: dict):
    if isinstance(tree, dict):
        return {k: vals[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(vals[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **vals)


def _unflatten_into(tree, arrays: dict, prefix: str = ""):
    """The structure of `tree` with its leaves read from `arrays`, each
    converted to the template leaf's dtype (a numpy array for an array or
    tensor leaf, a 0-d array for a Python scalar; a CPU tensor for a bf16
    tensor leaf)."""
    kids = _children(tree)
    if kids is None:
        arr = arrays[prefix]
        dtype = _host_dtype(tree)
        arr = arr if arr.dtype == dtype else arr.astype(dtype)
        if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
            return torch.from_numpy(arr).view(torch.bfloat16)
        return arr
    vals = {name: _unflatten_into(
        child, arrays, f"{prefix}/{name}" if prefix else name)
        for name, child in kids}
    return _rebuild(tree, vals)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = True,
             extra: dict | None = None):
        """Snapshot a state tree, fetched to the host before an async
        write.  `extra` is an optional JSON-serializable payload stored in
        the manifest and handed back by `manifest()`."""
        host_state = _to_host(state)      # device -> host now
        if blocking:
            self._write(step, host_state, extra)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state, extra),
                daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_state, extra: dict | None = None):
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        arrays = _flatten(host_state)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "keys": sorted(arrays),
                       "extra": extra}, f)
        final = os.path.join(self.dir, f"step-{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        snaps = self.list_steps()
        for s in snaps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.list_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int | None = None) -> dict:
        """The JSON manifest of a snapshot (latest by default)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step-{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, template, step: int | None = None) -> tuple:
        """Restore into the structure and dtypes of `template`; returns
        `(state of host arrays, step)` (bf16 leaves as CPU tensors)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step-{step:08d}", "state.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten_into(template, arrays), step


# ---------------------------------------------------------------------------
# Public SimState snapshot API (the engine/serve entry points)
# ---------------------------------------------------------------------------

def save_sim_state(directory: str, step: int, state, *,
                   extra: dict | None = None, keep: int = 3) -> str:
    """Write one atomic snapshot of a simulation-state tree (e.g. a
    `LaneSession.export()` dict: `SimState` arrays + lane keys + cycle)
    under `directory/step-XXXXXXXX/`, keeping the newest `keep`
    snapshots.  `extra` rides along in the manifest (JSON).  Returns the
    snapshot directory path."""
    ckpt = Checkpointer(directory, keep=keep)
    ckpt.save(step, state, blocking=True, extra=extra)
    return os.path.join(directory, f"step-{step:08d}")


def restore_sim_state(directory: str, template, step: int | None = None):
    """Restore a `save_sim_state` snapshot into the structure (shapes +
    dtypes) of `template`; returns `(state, extra, step)` for the
    requested snapshot (latest by default).  Integer and float counters
    come back exact, so a resumed run continues bit for bit."""
    ckpt = Checkpointer(directory)
    state, step = ckpt.restore(template, step=step)
    extra = ckpt.manifest(step).get("extra")
    return state, extra, step
