"""The port's dry-run (`repro_torch.launch.dryrun`) and its collective
accounting (`repro_torch.runtime.hlo_analysis`) against the reference.

- `classify_groups` / `collective_bytes` are held to the reference's
  `_classify_groups` / `collective_bytes` on synthesized HLO lines that
  carry the same groups: explicit ``{...}`` replica groups, iota
  ``[n,g]<=[...]T(...)`` groups and ``source_target_pairs``, over every
  single axis and contiguous combination of (16, 16) and (2, 16, 16), plus
  a strided mixed group.
- `lower_cell` on smoke configs at `mesh_shape=(2, 4)` is held to the
  reference's own `lower_cell` (in a subprocess, with `jax.make_mesh`
  patched to Auto axes: on this JAX the reference's dry-run needs them,
  ROADMAP queue 3): equal status, skip reason, chips, axis sizes, kind,
  parameter counts and argument bytes.  FLOPs and collectives are
  printed beside the reference's, not held: GSPMD and DTensor choose
  different collectives, and XLA counts a loop body once.
- Sanity of the port's own numbers: on a (1, 1) mesh the FLOPs equal
  `FlopCounterMode` over the real step; a (2, 2, 2) train cell moves
  bytes on "pod"; a (2, 4) train cell reduces gradients over "data".
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.runtime import hlo_analysis as JH
from repro_torch.launch import dryrun as D
from repro_torch.runtime import hlo_analysis as H

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SINGLE = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}


# --- collective accounting ------------------------------------------------------

def _groups_of(axis_sizes, axes):
    """All groups over the mesh axes `axes` (rank = row-major index)."""
    names = list(axis_sizes)
    ids = np.arange(int(np.prod(list(axis_sizes.values())))).reshape(
        [axis_sizes[a] for a in names])
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    arr = ids.transpose(rest + keep).reshape(-1, int(np.prod(
        [axis_sizes[a] for a in axes])))
    return arr, rest + keep, [axis_sizes[a] for a in names]


def _combos(axis_sizes):
    names = list(axis_sizes)
    out = [(a,) for a in names]
    for i in range(len(names)):
        for j in range(i + 2, len(names) + 1):
            out.append(tuple(names[i:j]))
    return out


def _hlo(op, nbytes, groups):
    return (f"  %x.1 = f32[{nbytes // 4}] {op}(f32[{nbytes // 4}] %p), "
            f"{groups}, to_apply=%add")


CASES = []
for _sizes in (SINGLE, POD):
    for _axes in _combos(_sizes):
        CASES.append((_sizes, _axes))


@pytest.mark.parametrize("axis_sizes,axes", CASES,
                         ids=[f"{len(s)}d-{'+'.join(a)}" for s, a in CASES])
def test_classify_groups_matches_reference(axis_sizes, axes):
    arr, perm, dims = _groups_of(axis_sizes, axes)
    group = arr[0].tolist()
    explicit = "replica_groups={" + ",".join(
        "{" + ",".join(map(str, g)) + "}" for g in arr.tolist()) + "}"
    iota = (f"replica_groups=[{arr.shape[0]},{arr.shape[1]}]<=["
            f"{','.join(map(str, dims))}]T({','.join(map(str, perm))})")
    want = JH._classify_groups(_hlo("all-reduce", 64, explicit), axis_sizes)
    assert JH._classify_groups(_hlo("all-reduce", 64, iota),
                               axis_sizes) == want
    assert H.classify_groups(group, axis_sizes) == want
    # the other groups of the same axes classify the same
    assert H.classify_groups(arr[-1].tolist(), axis_sizes) == want


@pytest.mark.parametrize("axis_sizes", [SINGLE, POD], ids=["2d", "3d"])
def test_classify_pairs_and_mixed_match_reference(axis_sizes):
    strides = H._strides(axis_sizes)
    for a, st in list(strides.items()) + [("skew", 3)]:
        line = ("  %x = f32[8] collective-permute(f32[8] %p), "
                f"source_target_pairs={{{{0,{st}}},{{{st},{2 * st}}}}}")
        want = JH._classify_groups(line, axis_sizes)
        assert H.classify_pair((0, st), axis_sizes) == want
    mixed = [0, 17, 34, 51]
    line = _hlo("all-gather", 64, "replica_groups={{0,17,34,51}}")
    assert H.classify_groups(mixed, axis_sizes) \
        == JH._classify_groups(line, axis_sizes) == "mixed"
    assert H.classify_groups([5], axis_sizes) == "none"


def test_collective_bytes_matches_reference():
    """The same collectives as HLO lines (reference) and as records (port):
    equal totals by op and by axis; every port op has mult 1."""
    lines, records = [], []
    specs = [("all-reduce", 4096, ("data",)), ("all-gather", 1024,
                                               ("model",)),
             ("reduce-scatter", 65536, ("data", "model")),
             ("all-to-all", 256, ("pod",)), ("all-reduce", 512,
                                             ("pod", "data"))]
    for op, nbytes, axes in specs:
        arr, _, _ = _groups_of(POD, axes)
        groups = "replica_groups={" + ",".join(
            "{" + ",".join(map(str, g)) + "}" for g in arr.tolist()) + "}"
        lines.append(_hlo(op, nbytes, groups))
        records.append({"op": op, "bytes": nbytes, "ranks": arr[0].tolist()})
    lines.append("  %cp = f32[16] collective-permute(f32[16] %p), "
                 "source_target_pairs={{0,16},{16,32}}")
    records.append({"op": "collective-permute", "bytes": 64,
                    "ranks": [0, 16]})
    ref = JH.collective_bytes("\n".join(lines), POD)
    got = H.collective_bytes(records, POD)
    assert got["by_op"] == ref["by_op"]
    assert got["by_axis"] == ref["by_axis"]
    assert [o["mult"] for o in got["ops"]] == [1] * len(records)


# --- dry-run cells against the reference's -------------------------------------

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    _make_mesh = jax.make_mesh

    def make_mesh(shape, names, **kw):
        kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
        return _make_mesh(shape, names, **kw)

    jax.make_mesh = make_mesh
    from repro.launch import dryrun as D
    out = {}
    for arch, shape in json.loads(sys.argv[2]):
        out[arch + "/" + shape] = D.lower_cell(arch, shape, False,
                                               mesh_shape=(2, 4))
    json.dump(out, open(sys.argv[1], "w"))
""")

CELLS = [("minicpm-2b-smoke", "train_4k"), ("minicpm-2b-smoke", "decode_32k"),
         ("deepseek-moe-16b-smoke", "train_4k"),
         ("mamba2-780m-smoke", "long_500k"),
         ("llama3.2-3b-smoke", "long_500k")]
HELD = ("status", "reason", "chips", "axis_sizes", "kind", "params",
        "active_params")


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                          json.dumps(CELLS)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.load(open(out))


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}"
                                                   for a, s in CELLS])
def test_lower_cell_matches_reference(reference_cells, arch, shape):
    ref = reference_cells[f"{arch}/{shape}"]
    art = D.lower_cell(arch, shape, False, mesh_shape=(2, 4), device="cpu")
    for k in HELD:
        assert art.get(k) == ref.get(k), k
    if art["status"] != "ok":
        return
    assert art["memory"]["argument_size_in_bytes"] \
        == ref["memory"]["argument_size_in_bytes"]
    assert art["memory"]["temp_size_in_bytes"] > 0 and art["flops"] > 0
    print(f"\n{arch} x {shape}: flops port {art['flops']:.4e} reference "
          f"{ref['flops']:.4e}; temp bytes port "
          f"{art['memory']['temp_size_in_bytes']} reference "
          f"{ref['memory']['temp_size_in_bytes']}; collectives port "
          f"{art['collectives']['by_axis']} reference "
          f"{ref['collectives']['by_axis']}")


def test_lower_cell_refuses_a_live_process_group():
    from repro_torch.launch.dryrun import fake_group
    with fake_group(2):
        with pytest.raises(RuntimeError, match="already initialised"):
            D.lower_cell("minicpm-2b-smoke", "decode_32k", False,
                         mesh_shape=(1, 2), device="cpu")
    assert not torch.distributed.is_initialized()


# --- the port's own numbers -----------------------------------------------------

def test_one_rank_flops_equal_the_real_step():
    """On a (1, 1) mesh the dry-run's FLOPs are `FlopCounterMode`'s over
    the real (plain) train step of the same model, batch and length."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.optim.optimizer import OptConfig, init_opt_state
    from repro_torch.runtime.trainer import TrainSetup, make_train_step
    B, S = 2, 64
    art = D.lower_cell("minicpm-2b-smoke", "train_4k", False,
                       mesh_shape=(1, 1), device="cpu", batch=B, seq_len=S)
    cfg = get_config("minicpm-2b-smoke")
    model = TF.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(model)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}
    step = make_train_step(TrainSetup(model=cfg, opt=OptConfig(),
                                      attn_impl="chunked"))
    with FlopCounterMode(display=False) as fc:
        step(model, opt, batch)
    assert art["flops"] == fc.get_total_flops()
    assert art["collectives"]["num_ops"] == 0


REPLAYED = [("minicpm-2b-smoke", "prefill_32k"),
            ("mamba2-780m-smoke", "prefill_32k"),
            ("qwen3-moe-235b-a22b-smoke", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", REPLAYED,
                         ids=[f"{a}-{s}" for a, s in REPLAYED])
def test_replayed_local_cores_count_what_a_full_trace_counts(
        monkeypatch, arch, shape):
    """Without autograd the dry-run replays a layer's local core (the
    attention, the SSD mixer, the MoE dispatch) from the first layer
    alike: its FLOPs, temp bytes and collectives equal those of a trace
    that runs every layer's core."""
    import contextlib
    kw = dict(mesh_shape=(2, 4), device="cpu", seq_len=2048)
    replayed = D.lower_cell(arch, shape, False, **kw)
    monkeypatch.setattr(D.LocalCost, "replay_local_cores",
                        lambda self: contextlib.nullcontext())
    full = D.lower_cell(arch, shape, False, **kw)
    assert replayed["flops"] == full["flops"] > 0
    assert replayed["memory"] == full["memory"]
    assert replayed["collectives"] == full["collectives"]


def test_multi_pod_train_cell_uses_pod_axis():
    art = D.lower_cell("minicpm-2b-smoke", "train_4k", False,
                       mesh_shape=(2, 2, 2), device="cpu", batch=8,
                       seq_len=64)
    assert art["axis_sizes"] == {"pod": 2, "data": 2, "model": 2}
    assert art["chips"] == 8
    assert art["collectives"]["by_axis"].get("pod", 0) > 0


def test_train_cell_reduces_gradients_over_data():
    art = D.lower_cell("minicpm-2b-smoke", "train_4k", False,
                       mesh_shape=(2, 4), device="cpu", batch=8, seq_len=64)
    assert art["collectives"]["by_axis"].get("data", 0) > 0
    assert art["memory"]["output_size_in_bytes"] \
        == art["memory"]["alias_size_in_bytes"] > 0


def test_main_writes_artifacts_and_counts_failures(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    calls = []

    def fake_lower(arch, shape, multi_pod, device=None):
        calls.append((arch, shape, multi_pod))
        if shape == "decode_32k":
            raise ValueError("boom")
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": "r"}

    monkeypatch.setattr(D, "lower_cell", fake_lower)
    n = D.main(["--arch", "minicpm-2b", "--shape", "decode_32k",
                "--mesh", "both"])
    assert n == 2 and len(calls) == 2
    art = json.load(open(D.cell_path("minicpm-2b", "decode_32k", True)))
    assert art["status"] == "error" and "boom" in art["traceback"]
    # cached artifacts are skipped without --force
    assert D.main(["--arch", "minicpm-2b", "--shape", "decode_32k",
                   "--mesh", "single"]) == 0 and len(calls) == 2


def test_main_traces_cells_in_worker_processes(tmp_path, monkeypatch):
    """``--jobs 2``: each cell in its own spawned process with its own
    fake group (here a smoke model's decode at 256 and 512 ranks)."""
    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    n = D.main(["--arch", "mamba2-780m-smoke", "--shape", "long_500k",
                "--mesh", "both", "--jobs", "2"], device="cpu")
    assert n == 0
    for multi, chips in ((False, 256), (True, 512)):
        art = json.load(open(D.cell_path("mamba2-780m-smoke", "long_500k",
                                          multi)))
        assert art["status"] == "ok" and art["chips"] == chips
