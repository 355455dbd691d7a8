"""Checkpointing: atomic on-disk snapshots of a state tree, an async save
thread, and restore with placement onto a mesh that may differ from the
writer's (elastic restart).  Port of `repro.checkpoint.checkpointing`,
in its on-disk format: a snapshot written by either package restores in
the other.

A state tree is nested dicts, lists/tuples and dataclasses (`SimState`)
with numpy arrays, torch tensors or Python scalars at the leaves.  Format:
one .npz per snapshot with flattened "path/to/leaf -> array" keys + a
small JSON manifest; writes go to a temp dir then rename (atomic), and a
retention policy keeps the newest K snapshots.  numpy has no bfloat16, so
a bf16 tensor is saved as the reference's `np.savez` saves its bfloat16
arrays: the 16-bit patterns as raw void bytes (``V2``).  Restore reads a
void leaf through the template's dtype, bit for bit, and converts any
other dtype mismatch, as the reference does; one exception keeps the
port's older snapshots readable: an ``int16`` leaf restored into a bf16
tensor is read as its bit pattern too.
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


# a bf16 leaf on disk: its 16-bit patterns as raw bytes, the reference's
# (ml_dtypes) format
_BF16_DISK = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_DISK)
        return t.numpy()
    return np.asarray(leaf)


def _host_dtype(leaf) -> np.dtype:
    """The numpy dtype a leaf restores to, without fetching it (int16, the
    bit patterns, for a bf16 tensor)."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.int16 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _read_leaf(arr: np.ndarray, leaf):
    """A snapshot array in the template leaf's dtype: a numpy array (a
    0-d one for a Python scalar), or a CPU tensor for a bf16 tensor.  A
    void array of the template's item size is read bit for bit, as is an
    int16 one into a bf16 tensor (the port's older snapshots); any other
    mismatch is converted."""
    dtype = _host_dtype(leaf)
    bits = arr.dtype.kind == "V" and arr.dtype.itemsize == dtype.itemsize
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        if bits or arr.dtype == np.int16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr).to(torch.bfloat16)
    if arr.dtype == dtype:
        return arr
    return arr.view(dtype) if bits else arr.astype(dtype)


def _place(value, sharding):
    """A restored leaf as a DTensor of `sharding` (a `runtime.sharding.
    NamedSharding`: a mesh and the placements on it).  Every rank holds
    the full array it read: each keeps its own shard, and nothing is
    sent."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.as_tensor(value).to(sharding.mesh.device_type)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


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


def _unflatten_into(tree, arrays: dict, shardings=None, prefix: str = ""):
    """The structure of `tree` with its leaves read from `arrays`
    (`_read_leaf`); a leaf whose entry in `shardings` (a tree shaped like
    `tree`, or None) is not None comes back as a DTensor of it.  A
    sharding in place of a subtree places every leaf under it."""
    kids = _children(tree)
    if kids is None:
        value = _read_leaf(arrays[prefix], tree)
        return value if shardings is None else _place(value, shardings)
    if shardings is None or hasattr(shardings, "placements"):
        sub = dict.fromkeys((name for name, _ in kids), shardings)
    else:
        sub = dict(_children(shardings))
    vals = {name: _unflatten_into(
        child, arrays, sub.get(name),
        f"{prefix}/{name}" if prefix else name)
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

    def restore(self, template, step: int | None = None,
                shardings=None) -> tuple:
        """Restore into the structure and dtypes of `template`; returns
        `(state, step)`: host arrays, bf16 leaves as CPU tensors.  With
        `shardings` (a tree shaped like `template`, as `runtime.sharding.
        shardings(specs, mesh)` gives it for the mesh to restore onto,
        which may differ from the writer's: elastic restart), a leaf with
        a sharding comes back as a DTensor of it on its mesh; a None leaf
        as without."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step-{step:08d}", "state.npz")
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten_into(template, arrays, shardings), step


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
