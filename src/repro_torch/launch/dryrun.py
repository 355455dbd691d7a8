"""Production-mesh dry-run (port of `repro.launch.dryrun`): every (arch x
shape x mesh) cell's train, prefill or decode step traced once on one
rank of the 256- or 512-rank mesh, without weights.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both [--force]

writes one JSON artifact a cell under ``artifacts/dryrun_torch/`` with
the reference's keys.  The mechanism differs from the reference's
compile-only lowering:

- `lower_cell` makes a ``fake`` `torch.distributed` process group of the
  mesh's world size in this one process (it refuses to run beside a real
  group) and destroys it when the cell ends;
- the model, the AdamW state (train), the cache (prefill, decode) and
  `configs.registry.input_specs` are built under `FakeTensorMode` on
  `device` (CUDA by default, the deployment target), placed as DTensors
  by `runtime.sharding`'s specs, and one step of `runtime.trainer`'s
  functions runs on them;
- ``flops`` are the FLOPs of the local ops rank 0 runs (per device, as
  XLA's `cost_analysis` reports them), counted below DTensor's dispatch
  with `torch.utils.flop_counter`'s formulas;
- ``memory`` holds the reference's five keys: the inputs' local bytes
  (``argument_size_in_bytes``), the donated inputs (params and state for
  train, the cache otherwise) as ``output_size_in_bytes`` and
  ``alias_size_in_bytes``, the peak of the bytes the step allocates and
  holds live beyond its inputs (``temp_size_in_bytes``, from this
  module's own tally mode over the fake tensors' storages), and 0 bytes
  of generated code;
- ``collectives`` come from `runtime.hlo_analysis.record_collectives`;
- without autograd (prefill, decode) a layer's local core alike to one
  already traced is replayed, its counts added again
  (`LocalCost.replay_local_cores`; `tools/dryrun_replay.py` times a cell
  both ways).

``t_lower_s`` is the placement, ``t_compile_s`` the traced step.  A
placement that fails fails the cell, with its traceback: there is no
smaller mesh, replicated layout or CPU to fall back to.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from contextlib import contextmanager

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import LM_SHAPES, shape_by_name
from ..configs.registry import ARCHS, cell_applicable, get_config, input_specs
from ..models import transformer as TF
from ..optim.optimizer import OptConfig, init_opt_state
from ..runtime import sharding as SH
from ..runtime.hlo_analysis import collective_bytes, record_collectives
from ..runtime.trainer import (TrainSetup, make_decode_step,
                               make_prefill_step, make_train_step,
                               place_model, place_tree)
from .mesh import make_production_mesh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of `world_size` ranks in this process, as
    rank 0; destroyed on exit.  Refuses to start beside a live group."""
    import torch.distributed as dist
    # registers the ``fake`` backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group; "
                           "a process group is already initialised")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(tree) -> int:
    """Local bytes of every tensor of a tree (dicts, lists, tensors)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    t = _local(tree)
    return t.numel() * t.element_size()


def _tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (at the top level or in a list
    or tuple argument)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class LocalCost(TorchDispatchMode):
    """Counts, on this rank's local tensors only (below DTensor, which
    handles its own ops and sends their local ops back through here):
    ``flops`` by `torch.utils.flop_counter`'s formulas, and the peak of
    the bytes of the storages the ops allocate while they stay alive
    (``peak_bytes``; a storage counts once, however many views)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.live = 0
        self.peak_bytes = 0
        self._refs: dict = {}
        self._sizes: dict = {}
        self._memo: dict = {}
        self.paused = 0

    @contextmanager
    def quiet_shape_propagation(self):
        """Pause the counts while DTensor derives an op's global output
        shape by running the op on global-shaped fake tensors (once a
        signature, then cached): that op is no part of the step."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        cost = self

        def propagate(self_, op_schema):
            cost.paused += 1
            try:
                return orig(self_, op_schema)
            finally:
                cost.paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def _drop(self, key):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def _track(self, t):
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def call(self, key, fn, args):
        """fn(*args) (local tensors, no autograd); a call with `key` and
        argument shapes seen before adds the first call's FLOPs and peak
        and returns fresh outputs of its shapes (or the argument an output
        was), without running fn again.  An in-place write to an argument
        allocates nothing, so a replay that skips it misses no byte."""
        sig = (key,) + tuple(
            (tuple(a.shape), a.dtype, tuple(a.stride()))
            if isinstance(a, torch.Tensor) else a for a in args)
        entry = self._memo.get(sig)
        if entry is None:
            flops0, live0, peak0 = self.flops, self.live, self.peak_bytes
            self.peak_bytes = self.live
            out = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            recipe = []
            for o in outs:
                hit = [i for i, a in enumerate(args) if o is a]
                if hit:
                    recipe.append(("arg", hit[0]))
                else:
                    st = o.untyped_storage()
                    recipe.append(("new", tuple(o.shape), tuple(o.stride()),
                                   o.storage_offset(), o.dtype,
                                   st.nbytes() // o.element_size(),
                                   o.device))
            self._memo[sig] = (self.flops - flops0,
                               self.peak_bytes - live0, recipe,
                               isinstance(out, tuple))
            self.peak_bytes = max(peak0, self.peak_bytes)
            return out
        flops, rise, recipe, is_tuple = entry
        self.flops += flops
        self.peak_bytes = max(self.peak_bytes, self.live + rise)
        outs = []
        for r in recipe:
            if r[0] == "arg":
                outs.append(args[r[1]])
            else:
                _, shape, stride, offset, dtype, numel, device = r
                outs.append(torch.empty(numel, dtype=dtype, device=device)
                            .as_strided(shape, stride, offset))
        return tuple(outs) if is_tuple else outs[0]

    @contextmanager
    def replay_local_cores(self):
        """While open, a local core (`models.placement.local`, through
        `local_map`) called without autograd, with the code, configuration
        and local argument shapes of one seen before, is replayed by
        `call` instead of traced again: the layers of a prefill or decode
        step are alike, and each would trace the same ops (a 32k prefill
        traces ~2,000 attention blocks a layer).  A core whose closure
        holds something unhashable is always traced."""
        import torch.distributed.tensor.experimental as experimental
        orig = experimental.local_map
        cost = self

        def memo_local_map(fn, *a, **kw):
            cells = tuple(c.cell_contents for c in fn.__closure__ or ())
            key = (fn.__code__, cells)
            try:
                hash(key)
            except TypeError:
                return orig(fn, *a, **kw)

            def replayed(*args):
                if torch.is_grad_enabled():
                    return fn(*args)
                return cost.call(key, fn, args)
            return orig(replayed, *a, **kw)

        experimental.local_map = memo_local_map
        try:
            yield
        finally:
            experimental.local_map = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":
            # metadata queries (``prim.device``): no FLOPs, no storage
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        leaves = _tensors(args, kwargs)
        if any(isinstance(a, DTensor) for a in leaves):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            # DTensor's shape propagation, not the step
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](
                *args, **kwargs, out_val=out))
        inputs = {a.untyped_storage()._cdata for a in leaves}
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            # an output on an input's storage is a view or an in-place
            # result: it allocates nothing (but keeps a tracked storage
            # alive)
            if isinstance(t, torch.Tensor) and (
                    t.untyped_storage()._cdata not in inputs
                    or t.untyped_storage()._cdata in self._refs):
                self._track(t)
        return out


def _fake_like(t, device):
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               save_hlo: bool = False, mesh_shape: tuple | None = None,
               tag: str | None = None, moe_dispatch: str = "bf16",
               microbatch: int = 1, device=None, batch: int | None = None,
               seq_len: int | None = None):
    """Trace one (arch x shape x mesh) cell; returns the artifact dict
    (raises on real failures).

    mesh_shape: an override of the production mesh - (data, model), or
    (pod, data, model).  moe_dispatch: "bf16" | "int8".  device: the
    fake tensors' device ("cuda" by default).  batch, seq_len: overrides
    of the shape's global batch and sequence (cache) length, to predict a
    step the card can also run.  `save_hlo` adds nothing (the port has no
    HLO) and is kept for the reference's signature."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    if moe_dispatch != "bf16" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=moe_dispatch))
    shape = shape_by_name(shape_name)
    if batch is not None or seq_len is not None:
        shape = dataclasses.replace(shape,
                                    global_batch=batch or shape.global_batch,
                                    seq_len=seq_len or shape.seq_len)
    mesh_tag = tag or ("multi" if multi_pod else "single")
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "status": "skipped", "reason": why}
    device = torch.device(device or "cuda")
    if mesh_shape is not None:
        mesh_shape = tuple(int(n) for n in mesh_shape)
    dims = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    setup = TrainSetup(model=cfg, opt=OptConfig(), attn_impl="chunked",
                       microbatch=microbatch)

    with fake_group(int(np.prod(dims))):
        if mesh_shape is not None:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(device.type, mesh_shape,
                                    mesh_dim_names=AXES[len(mesh_shape)])
        else:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device.type)
        axis_sizes = {n: int(s) for n, s in
                      zip(mesh.mesh_dim_names, mesh.mesh.shape)}
        with FakeTensorMode(allow_non_fake_inputs=True):
            run = _trace(cfg, shape, setup, mesh, device)
    coll = collective_bytes(run["records"], axis_sizes)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_tag,
        "status": "ok",
        "axis_sizes": axis_sizes,
        "chips": int(np.prod(dims)),
        "kind": shape.kind,
        "flops": float(run["flops"]),
        "memory": {k: int(v) for k, v in run["memory"].items()},
        "collectives": {"by_op": coll["by_op"], "by_axis": coll["by_axis"],
                        "num_ops": len(coll["ops"])},
        "t_lower_s": round(run["t_lower"], 2),
        "t_compile_s": round(run["t_compile"], 2),
        "params": cfg.num_params(),
        "active_params": cfg.active_params(),
    }


def _trace(cfg, shape, setup, mesh, device) -> dict:
    """Build, place and trace one cell under the active fake tensor mode:
    its FLOPs, memory and collective records, and the two timings."""
    t0 = time.time()
    model = TF.Transformer(cfg, device)
    pspecs = SH.tree_param_specs(model, mesh)
    batch = {k: _fake_like(v, device)
             for k, v in input_specs(cfg, shape).items()}
    bspecs = SH.batch_specs(batch, mesh)
    if shape.kind == "train":
        state = init_opt_state(model)
        place_tree(state, SH.opt_specs(pspecs, model, mesh), mesh)
    else:
        state = TF.init_cache(cfg, shape.global_batch, shape.seq_len, device)
        place_tree(state, SH.cache_specs(state, mesh), mesh)
    place_model(model, pspecs, mesh)
    place_tree(batch, bspecs, mesh)
    params = dict(model.named_parameters())
    donated = _nbytes(state) + (_nbytes(params) if shape.kind == "train"
                                else 0)
    memory = {
        "generated_code_size_in_bytes": 0,
        "argument_size_in_bytes": _nbytes(params) + _nbytes(state)
        + _nbytes(batch),
        "output_size_in_bytes": donated,
        "temp_size_in_bytes": 0,
        "alias_size_in_bytes": donated,
    }
    t_lower = time.time() - t0

    t0 = time.time()
    cost = LocalCost()
    with record_collectives() as records, cost, \
            cost.quiet_shape_propagation(), cost.replay_local_cores():
        if shape.kind == "train":
            make_train_step(setup, mesh)(model, state, batch)
        elif shape.kind == "prefill":
            make_prefill_step(setup, mesh)(model, batch, state)
        else:
            make_decode_step(setup, mesh)(model, batch, state)
    memory["temp_size_in_bytes"] = cost.peak_bytes
    return {"flops": cost.flops, "memory": memory, "records": records,
            "t_lower": t_lower, "t_compile": time.time() - t0}


def cell_path(arch, shape_name, multi_pod):
    tag = "multi" if multi_pod else "single"
    return os.path.join(ART_DIR, f"{arch}__{shape_name}__{tag}.json")


def run_cell(arch: str, shape_name: str, multi_pod: bool, device=None):
    """`lower_cell`'s artifact, or the reference's error artifact (with the
    traceback) when it raises."""
    tag = "multi" if multi_pod else "single"
    try:
        return lower_cell(arch, shape_name, multi_pod, device=device)
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": tag,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()[-3000:]}


def run_cells(cells, jobs: int = 1, device=None):
    """Yield ((arch, shape, multi_pod), artifact) for every cell, in turn
    (`jobs` 1) or from `jobs` worker processes (spawned, each with its own
    fake process group), in the order they finish."""
    if jobs <= 1:
        for cell in cells:
            yield cell, run_cell(*cell, device=device)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    with ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {pool.submit(run_cell, *cell, device=device): cell
                   for cell in cells}
        try:
            for fut in as_completed(futures):
                yield futures[fut], fut.result()
        finally:
            for fut in futures:
                fut.cancel()


def main(argv=None, device=None) -> int:
    """The reference's command line (plus ``--jobs``: cells traced by that
    many worker processes at once); returns the count of failed cells
    (each written with its traceback)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    os.makedirs(ART_DIR, exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in LM_SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                path = cell_path(arch, shape_name, multi_pod)
                if os.path.exists(path) and not args.force:
                    print(f"[skip-cached] {os.path.basename(path)}")
                    continue
                cells.append((arch, shape_name, multi_pod))

    failures = 0
    t0 = time.time()
    for (arch, shape_name, multi_pod), art in run_cells(cells, args.jobs,
                                                        device):
        tag = "multi" if multi_pod else "single"
        print(f"[lower] {arch} x {shape_name} x {tag} ...", flush=True)
        with open(cell_path(arch, shape_name, multi_pod), "w") as f:
            json.dump(art, f, indent=1)
        if art["status"] == "ok":
            print(f"  ok: flops={art['flops']:.3e} "
                  f"coll={art['collectives']['by_axis']} "
                  f"compile={art['t_compile_s']}s", flush=True)
        elif art["status"] == "skipped":
            print(f"  skipped: {art['reason']}", flush=True)
        else:
            failures += 1
            print(f"  ERROR: {art['error']}", flush=True)
    print(f"done; failures={failures}; {len(cells)} cells in "
          f"{time.time() - t0:.1f} s")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
