"""Local `gloo` ranks for the port's tests, and the sharded-trainer
tests' rank bodies (`tests/test_torch_train.py`): a module of its own
that imports no JAX, so each spawned rank starts with torch and the port
only.

`run_ranks(fn, world, store, args)` runs ``fn(rank, world, *args)`` in a
process a rank (spawned), one gloo group over a `FileStore` at `store`
(no TCP port, so tests under xdist do not clash), a time limit on the
whole; it returns each rank's value (numpy arrays, numbers, dicts and
lists of them).  A rank that raises, or a run past `timeout` seconds,
kills every rank and raises, so a hang fails one test.  `fn` must be
importable by name (a module's top level).
"""
import os
import queue
import traceback

import numpy as np
import torch

from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.data import pipeline as TD
from repro_torch.runtime import trainer as TT

def _main(rank, world, store, fn, args, out):
    try:
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(store), world), rank=rank,
            world_size=world)
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", res))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, store, args=(), timeout: float = 120.0):
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each on its
    own gloo rank; raises RuntimeError naming the first rank that failed
    (with its traceback) or the time limit."""
    import time

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_main, args=(r, world, os.fspath(store), fn,
                                             args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(results))} did "
                    f"not finish within {timeout} s")
            try:
                rank, status, res = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


SHARDED_STEPS = 2


def sharded_setup(tcfg, opt):
    return TT.TrainSetup(model=tcfg, opt=opt,
                         attn_impl="chunked", remat=True)


def sharded_trainer(rank, world, tcfg, opt, named, model_axis):
    """`Trainer(..., mesh=make_host_mesh(model_axis))` on the gloo ranks,
    from the reference's weights (`named`: name -> numpy), two steps;
    rank 0 returns the metrics and the full parameters."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=model_axis, device_type="cpu")
    data = TD.SyntheticTokens(tcfg.vocab_size, 4, 32, seed=3)
    tr = TT.Trainer(sharded_setup(tcfg, opt), data, device="cpu",
                    mesh=mesh)
    with torch.no_grad():
        TT._copy_into(dict(tr.model.named_parameters()), named)
        TT._copy_into(tr.opt_state["master"], named)
    hist = tr.run(SHARDED_STEPS)
    full = {n: TT.full(p).detach().numpy() for n, p in
            tr.model.named_parameters()}
    placed = sum(type(p).__name__ == "DTensor"
                 for p in tr.model.parameters())
    return (hist, full, placed, tr.pspecs) if rank == 0 else placed


def one_rank_trainer(rank, world, tcfg, opt, ckpt_dir):
    """The sharded and the plain `Trainer` from the same seed on a
    one-rank mesh: both histories, the largest parameter gap, both
    checkpoints' arrays, and the sharded trainer's parameters after it
    restores its checkpoint over a further step."""
    from repro_torch.launch.mesh import make_host_mesh
    runs = []
    for mesh in (make_host_mesh(model=1, device_type="cpu"), None):
        data = TD.SyntheticTokens(tcfg.vocab_size, 4, 32, seed=3)
        tag = "plain" if mesh is None else "sharded"
        tr = TT.Trainer(sharded_setup(tcfg, opt), data, device="cpu",
                        mesh=mesh, seed=1, checkpointer=Checkpointer(
                            os.path.join(ckpt_dir, tag), keep=1))
        hist = list(tr.run(SHARDED_STEPS))
        tr.save()
        step = tr.ckpt.latest_step()
        with np.load(os.path.join(ckpt_dir, tag, f"step-{step:08d}",
                                  "state.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        params = {n: TT.full(p).detach().clone() for n, p in
                  tr.model.named_parameters()}
        runs.append((hist, params, arrays))
        if mesh is not None:
            tr.run(1)
            tr.restore()
            back = max(float((TT.full(p).detach() - params[n]).abs().max())
                       for n, p in tr.model.named_parameters())
    (hs, ps, za), (hp, pp, zb) = runs
    gap = max(float((ps[n] - pp[n]).abs().max()) for n in pp)
    same = sorted(za) == sorted(zb) and all(
        np.array_equal(za[k], zb[k]) for k in za)
    return hs, hp, gap, same, back


def moe_sharded_grads(rank, world, tcfg, tokens, labels):
    """deepseek-moe-16b-smoke (fp32) on a (2, 2) mesh: the loss, its nll
    and aux, and every parameter's gradient, full, on rank 0, from the
    same seeded weights the plain check uses."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.runtime import sharding as SH
    mesh = make_host_mesh(model=2, device_type="cpu")
    model = TF.init_params(tcfg, torch.Generator().manual_seed(7), "cpu")
    TT.place_model(model, SH.tree_param_specs(model, mesh), mesh)
    batch = TT._placed({"tokens": tokens, "labels": labels}, mesh, "cpu")
    loss, met = TF.lm_loss(model, tcfg, batch, attn_impl="chunked",
                           remat=True, constrain=SH.make_constrain(mesh))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    out = {"loss": float(TT.full(loss)), "nll": float(TT.full(met["nll"])),
           "aux": float(TT.full(met["aux"]))}
    full = {n: TT.full(g).detach().numpy() for n, g in zip(names, grads)}
    experts = [p for n, p in model.named_parameters() if n.endswith("ffn.wi")]
    placements = [str(p.placements) for p in experts]
    return (out, full, placements) if rank == 0 else None


def moe_sharded_against_reference(rank, world, tcfg, opt, named):
    """deepseek-moe-16b-smoke (fp32) on a (2, 2) mesh from the reference's
    weights (`named`): the loss, nll and aux of the first batch and every
    parameter's gradient, full, then `Trainer(mesh=...)`'s two steps from
    the same weights; rank 0 returns (loss parts, gradients, the steps'
    metrics, the full parameters after them)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.runtime import sharding as SH
    mesh = make_host_mesh(model=2, device_type="cpu")
    model = TF.Transformer(tcfg, "cpu")
    with torch.no_grad():
        TT._copy_into(dict(model.named_parameters()), named)
    TT.place_model(model, SH.tree_param_specs(model, mesh), mesh)
    batch = next(TD.SyntheticTokens(tcfg.vocab_size, 4, 32, seed=3))
    batch = TT._placed({k: torch.as_tensor(v) for k, v in batch.items()},
                       mesh, "cpu")
    loss, met = TF.lm_loss(model, tcfg, batch, attn_impl="chunked",
                           remat=True, constrain=SH.make_constrain(mesh))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    first = {"loss": float(TT.full(loss)),
             "nll": float(TT.full(met["nll"])),
             "aux": float(TT.full(met["aux"]))}
    grads = {n: TT.full(g).detach().numpy() for n, g in zip(names, grads)}
    res = sharded_trainer(rank, world, tcfg, opt, named, 2)
    if rank != 0:
        return None
    hist, full, _, _ = res
    return first, grads, hist, full


def fp32_configs(get_config):
    """`get_config` with every model in fp32 (the launcher has no dtype
    flag; the tests' bar is the fp32 one)."""
    import dataclasses
    return lambda name: dataclasses.replace(get_config(name),
                                            dtype="float32")


def launcher(rank, world, argv):
    """`launch.train.main(argv)` on the gloo group (a host mesh over its
    ranks), its configs in fp32 (`fp32_configs`), then the same command
    line with `--production-mesh`, which must raise before building a
    weight; rank 0 returns the history, the full parameters, how many
    are DTensors and the error, the others the error."""
    from repro_torch.launch import train as LT
    LT.get_config = fp32_configs(LT.get_config)
    tr = LT.main(argv, device="cpu")
    full = {n: TT.full(p).detach().numpy()
            for n, p in tr.model.named_parameters()}
    placed = sum(type(p).__name__ == "DTensor"
                 for p in tr.model.parameters())
    try:
        LT.main(argv + ["--production-mesh"], device="cpu")
        err = None
    except ValueError as e:
        err = str(e)
    return (tr.history, full, placed, err) if rank == 0 else err


def elastic_restore(rank, world, ckpt_dir, saved, write_specs, read_specs):
    """Elastic restart on `world` ranks: the tensors of `saved` (a dict of
    numpy arrays; int16 ones are bf16 bit patterns) placed by
    `write_specs` on a ("data" world, "model" 1) mesh, gathered and
    written by rank 0, then restored by every rank onto a (1, world) mesh
    with `Checkpointer.restore(..., shardings=)` of `read_specs` (a
    Python scalar rides along unplaced).  A spec is a plain tuple of
    `PartitionSpec` entries.  Returns this rank's local
    shards, the restored full tensors (bf16 as int16 patterns), each
    leaf's placements and the restored scalar."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import sharding as SH

    def tensor(a):
        t = torch.from_numpy(a)
        return t.view(torch.bfloat16) if a.dtype == np.int16 else t

    def host(t):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()

    writer = init_device_mesh("cpu", (world, 1),
                              mesh_dim_names=("data", "model"))
    placed = {k: SH.distribute(tensor(a), SH.P(*write_specs[k]), writer)
              for k, a in saved.items()}
    full = {k: TT.full(t) for k, t in placed.items()}
    ckpt = Checkpointer(ckpt_dir, keep=1)
    if rank == 0:
        ckpt.save(7, dict(full, cycle=4096))
    dist.barrier()
    reader = init_device_mesh("cpu", (1, world),
                              mesh_dim_names=("data", "model"))
    shardings = dict(SH.shardings({k: SH.P(*s) for k, s in
                                   read_specs.items()}, reader), cycle=None)
    template = dict({k: torch.zeros_like(t) for k, t in full.items()},
                    cycle=0)
    back, step = ckpt.restore(template, shardings=shardings)
    assert step == 7
    return dict(local={k: host(back[k].to_local()) for k in saved},
                full={k: host(TT.full(back[k])) for k in saved},
                placements={k: repr(back[k].placements) for k in saved},
                mesh={k: back[k].device_mesh.mesh.tolist() for k in saved},
                cycle=int(back["cycle"]))
