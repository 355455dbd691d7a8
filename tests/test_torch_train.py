"""The port's training path (`repro_torch.models.transformer.lm_loss`,
`optim`, `data`, `runtime`, `checkpoint`, `launch.train`) against the
reference on the CPU, with the same numpy inputs and the reference's
weights and optimizer state carried across (`params_from_jax`,
`opt_state_from_jax`).  The reference side is its own `make_train_step`
on a 1 x 1 mesh with Auto axes (`jax.make_mesh`'s default Explicit axes
break the reference's `Trainer` on this JAX; ROADMAP queue 3).

Tolerances, fp32: loss, nll, aux, lr and grad_norm at 1e-5 relative;
gradients at 3e-5 relative to each leaf's largest value (both sides sum
fp32 products in different orders; the SSD's chunked sums move most);
after 3 AdamW steps at lr 1e-3, every parameter and master leaf within
1e-5 absolute and the moments m, v within 1e-5 relative to each leaf's
largest value.  Data, compression and checkpoints: exact."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.sharding import AxisType

from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.models import transformer as JTF
from repro.optim import compression as JC
from repro.optim import optimizer as JO
from repro.runtime import sharding as JSH
from repro.runtime import trainer as JT
from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as TD
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import compression as TC
from repro_torch.optim import optimizer as TO
from repro_torch.runtime import trainer as TT
import torch_rank_jobs as jobs  # noqa: E402  (tests/, on sys.path)
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 FaultTolerantLoop,
                                                 StragglerMonitor)

METRICS = ("loss", "nll", "aux", "lr", "grad_norm")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _models(arch, dtype="float32", seed=0):
    """The reference's smoke params in `dtype` and the port's model with
    the same numbers, with both configs."""
    cfg = dataclasses.replace(jreg.get_config(arch + "-smoke"), dtype=dtype)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"), dtype=dtype)
    params = JTF.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    return cfg, params, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _leaf(tree, name):
    """The reference leaf of the port's parameter `name` (slice g of a
    stacked leaf for ``blocks.<g>.…``), as numpy."""
    parts = name.split(".")
    index = None
    if parts[0] == "blocks":
        index, parts = int(parts[1]), ["blocks"] + parts[2:]
    leaf = tree
    for part in parts:
        leaf = leaf[int(part)] if isinstance(leaf, list) else leaf[part]
    leaf = np.asarray(leaf, np.float32)
    return leaf if index is None else leaf[index]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _opt_config(ref):
    """The port's OptConfig with the reference's values; the reference's
    `compress_pod_grads` is read by nothing and is not ported."""
    fields = dataclasses.asdict(ref)
    fields.pop("compress_pod_grads")
    return TO.OptConfig(**fields)


def _np(t):
    return t.detach().float().numpy()


def _batch(cfg, B=4, S=32, seed=3):
    return next(TD.SyntheticTokens(cfg.vocab_size, B, S, seed=seed))


# --- the loss and its gradients ------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-780m",
                                  "recurrentgemma-2b", "deepseek-moe-16b"])
def test_lm_loss_and_gradients_match_the_reference(arch):
    """A dense, an SSM, a hybrid and an MoE smoke model in fp32 (naive
    attention, remat on both sides): the loss, its nll and aux terms, and
    the gradient of every parameter against `jax.value_and_grad`."""
    cfg, params, tcfg, model = _models(arch)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.lm_loss(p, cfg, jbatch, attn_impl="naive",
                              remat=True), has_aux=True))(params)
    tl, tm = TTF.lm_loss(model, tcfg,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         attn_impl="naive", remat=True)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(tl, ps)
    assert _rel(_np(tl), jl) < 1e-5
    for k in ("nll", "aux"):
        assert _rel(_np(tm[k]), jm[k]) < 1e-5
    if cfg.moe is not None:
        assert float(tm["aux"].detach()) > 0
    jg = jax.tree.map(np.asarray, jg)
    for name, g in zip(names, grads):
        assert _rel(_np(g), _leaf(jg, name)) < 3e-5, name


# --- AdamW and the schedules -------------------------------------------------

def test_adamw_update_matches_the_reference_leaf_by_leaf():
    """deepseek-moe-16b-smoke (a dense prelude layer, then stacked MoE
    blocks) with weight decay 0.1: the reference's first update, then
    the second from its state carried across; every param, master, m
    and v leaf, lr and the clipped grad norm.  The stacked blocks' norm
    scales are 2-D on the reference's tree and so decayed; the prelude's
    and final_norm's are not (`decays`)."""
    cfg, params, tcfg, model = _models("deepseek-moe-16b")
    opt = JO.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                       weight_decay=0.1)
    topt = _opt_config(opt)
    rng = np.random.default_rng(7)
    g1, g2 = (jax.tree.map(lambda p: rng.standard_normal(
        p.shape, dtype=np.float32) * 0.05, params) for _ in range(2))
    update = jax.jit(partial(JO.adamw_update, opt))
    p1, s1, _ = update(g1, JO.init_opt_state(params), params)
    p2, s2, jm = update(g2, s1, p1)

    model = params_from_jax(jax.tree.map(np.asarray, p1), tcfg, device="cpu")
    state = opt_state_from_jax(jax.tree.map(np.asarray, s1), model)
    assert int(state["step"]) == 1
    named = dict(model.named_parameters())
    grads = {n: torch.from_numpy(_leaf(g2, n).copy()) for n in named}
    _, state, tm = TO.adamw_update(topt, grads, state, named)
    assert float(tm["grad_norm"]) > opt.clip_norm       # clipping is on
    for k in ("lr", "grad_norm"):
        assert _rel(_np(tm[k]), jm[k]) < 1e-6
    assert int(state["step"]) == 2
    s2 = jax.tree.map(np.asarray, s2)
    for name, p in named.items():
        assert np.abs(_np(p) - _leaf(p2, name)).max() < 1e-6, name
        assert np.abs(_np(state["master"][name])
                      - _leaf(s2["master"], name)).max() < 1e-6, name
        for k in ("m", "v"):
            assert _rel(_np(state[k][name]), _leaf(s2[k], name)) < 1e-5
    assert TO.decays("blocks.0.sub0.norm1.scale", named[
        "blocks.0.sub0.norm1.scale"])
    assert not TO.decays("prelude.0.norm1.scale",
                         named["prelude.0.norm1.scale"])
    assert not TO.decays("final_norm.scale", named["final_norm.scale"])


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_the_reference(schedule):
    """Steps 0, 1, the end of warmup, mid-way, inside the WSD decay, the
    end and past it."""
    cfg = JO.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                       schedule=schedule, decay_frac=0.2, min_lr_frac=0.1)
    tcfg = _opt_config(cfg)
    for step in (0, 1, 10, 55, 85, 100, 120):
        want = float(JO.schedule_lr(cfg, jnp.asarray(step)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = TO.schedule_lr(tcfg, s)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6 * max(want, 1e-30)


# --- the train step ----------------------------------------------------------

@pytest.mark.parametrize("arch,microbatch,remat,attn", [
    ("deepseek-moe-16b", 2, True, "naive"),
    ("deepseek-moe-16b", 1, False, "naive"),
    ("minicpm-2b", 1, True, "chunked"),
    ("minicpm-2b", 2, False, "naive")])
def test_train_steps_match_the_reference(arch, microbatch, remat, attn):
    """Three steps of the reference's own `make_train_step` and the
    port's from the same weights and batches, fp32, lr 1e-3, weight decay
    0.1: the metrics of each step, then every parameter and optimizer
    leaf."""
    cfg, params, tcfg, model = _models(arch)
    opt = JO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                       weight_decay=0.1, schedule=cfg.schedule)
    jstep = jax.jit(JT.make_train_step(
        JT.TrainSetup(model=cfg, opt=opt, attn_impl=attn, remat=remat,
                      microbatch=microbatch), _mesh()))
    tstep = TT.make_train_step(TT.TrainSetup(
        model=tcfg, opt=_opt_config(opt),
        attn_impl=attn, remat=remat, microbatch=microbatch))
    jopt, topt = JO.init_opt_state(params), TO.init_opt_state(model)
    data = TD.SyntheticTokens(cfg.vocab_size, 4, 32, seed=3)
    for _ in range(3):
        batch = next(data)
        params, jopt, jm = jstep(params, jopt,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        model, topt, tm = tstep(model, topt, batch)
        for k in METRICS:
            assert _rel(_np(tm[k]), jm[k]) < 1e-5, k
    jparams = jax.tree.map(np.asarray, params)
    jopt = jax.tree.map(np.asarray, jopt)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    for name, p in model.named_parameters():
        assert np.abs(_np(p) - _leaf(jparams, name)).max() < 1e-5, name
        assert np.abs(_np(topt["master"][name])
                      - _leaf(jopt["master"], name)).max() < 1e-5, name
        for k in ("m", "v"):
            assert _rel(_np(topt[k][name]), _leaf(jopt[k], name)) < 1e-5, \
                (k, name)


def test_prefill_and_decode_steps_match_the_reference():
    cfg, params, tcfg, model = _models("minicpm-2b", seed=4)
    jsetup = JT.TrainSetup(model=cfg, opt=JO.OptConfig(), attn_impl="naive")
    tsetup = TT.TrainSetup(model=tcfg, opt=TO.OptConfig(), attn_impl="naive")
    toks = _batch(cfg, 2, 12, seed=5)["tokens"]
    jtok, jcache = JT.make_prefill_step(jsetup, _mesh())(
        params, {"tokens": jnp.asarray(toks)}, JTF.init_cache(cfg, 2, 16))
    ttok, tcache = TT.make_prefill_step(tsetup)(
        model, {"tokens": torch.from_numpy(toks)},
        TTF.init_cache(tcfg, 2, 16, device="cpu"))
    jdec, tdec = JT.make_decode_step(jsetup, _mesh()), \
        TT.make_decode_step(tsetup)
    for _ in range(3):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))
        jtok, jcache = jdec(params, {"tokens": jtok}, jcache)
        ttok, tcache = tdec(model, {"tokens": ttok}, tcache)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))


# --- data and compression ----------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_tokens_are_the_reference_s(seed, shard):
    """Byte-equal batches of one shard of two, and the same stream after a
    restore."""
    j = JD.SyntheticTokens(1000, 4, 16, seed=seed, shard_index=shard,
                           num_shards=2)
    t = TD.SyntheticTokens(1000, 4, 16, seed=seed, shard_index=shard,
                           num_shards=2)
    for _ in range(3):
        a, b = next(j), next(t)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    assert t.state() == j.state()
    t.restore({"step": 1})
    j.restore({"step": 1})
    assert next(t)["tokens"].tobytes() == next(j)["tokens"].tobytes()


def test_prefetcher_yields_everything():
    it = iter([{"i": np.asarray(i)} for i in range(7)])
    assert [b["i"].item() for b in TD.Prefetcher(it, depth=2)] == \
        list(range(7))


def test_ef_compression_matches_the_reference():
    """Two rounds of error feedback on three leaves: q, scales, the
    carried error and the decompressed tree, all exact."""
    rng = np.random.default_rng(8)
    grads = [{"w": rng.standard_normal((32, 16), dtype=np.float32),
              "b": rng.standard_normal(16, dtype=np.float32) * 1e-3,
              "z": np.zeros((4, 4), np.float32)} for _ in range(2)]
    jerr = JC.init_error_state(jax.tree.map(jnp.asarray, grads[0]))
    terr = TC.init_error_state({k: torch.from_numpy(v)
                                for k, v in grads[0].items()})
    for g in grads:
        jqt, jerr = JC.ef_compress_tree(jax.tree.map(jnp.asarray, g), jerr)
        tqt, terr = TC.ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr)
        jback = JC.decompress_tree(jqt)
        tback = TC.decompress_tree(tqt)
        for k in g:
            assert tqt[k][0].dtype == torch.int8
            assert np.array_equal(tqt[k][0].numpy(), np.asarray(jqt[k][0]))
            assert np.array_equal(tqt[k][1].numpy(), np.asarray(jqt[k][1]))
            assert np.array_equal(terr[k].numpy(), np.asarray(jerr[k]))
            assert np.array_equal(tback[k].numpy(), np.asarray(jback[k]))
    # the cross-pod reduction needs a process group (its gloo parity is in
    # tests/test_torch_collectives.py)
    with pytest.raises(RuntimeError, match="process group"):
        TC.pod_compressed_psum(grads[0], terr, mesh=None)


# --- the host loop, checkpoints and fault tolerance ------------------------

def _trainer(tmp_path, arch="minicpm-2b", steps=40, ckpt_every=0):
    cfg = treg.get_config(arch + "-smoke")
    opt = TO.OptConfig(lr=2e-3, warmup_steps=2, total_steps=steps,
                       schedule="wsd", weight_decay=0.0)
    setup = TT.TrainSetup(model=cfg, opt=opt, attn_impl="naive",
                          remat=False)
    data = TD.SyntheticTokens(cfg.vocab_size, batch=4, seq_len=32, seed=3)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    return TT.Trainer(setup, data, checkpointer=ckpt, ckpt_every=ckpt_every,
                      device="cpu")


def test_failure_injection_recovers_and_completes(tmp_path):
    """The reference's `test_failure_injection_recovers_and_completes` on
    the port (bf16 smoke model)."""
    tr = _trainer(tmp_path, ckpt_every=4)
    loop = FaultTolerantLoop(tr, FailureInjector(fail_at=(6, 13)))
    hist = loop.run(20)
    assert tr.step == 20
    assert loop.restarts == 2
    events = [e["event"] for e in loop.log]
    assert events.count("failure") == 2 and events.count("restart") == 2
    assert [e["resumed_step"] for e in loop.log
            if e["event"] == "restart"] == [4, 12]
    assert np.isfinite(hist[-1]["nll"])


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=2.0, alpha=0.5)
    for step in range(10):
        assert not mon.observe(step, 0.10 + 0.001 * step)
    assert mon.observe(10, 1.0)
    assert mon.events[0]["action"] == "redispatch-to-backup"
    assert mon.ema < 0.2


def test_trainer_checkpoint_roundtrip_is_bit_exact(tmp_path):
    """The reference's `test_checkpoint_roundtrip_bitexact` on the port,
    with the bf16 smoke model: run 10 steps (snapshots at 5 and 10), 5
    more, restore step 10: every param (bf16) and optimizer leaf bit for
    bit, and the data stream rewound."""
    tr = _trainer(tmp_path, ckpt_every=5)
    assert tr.model.embed.dtype == torch.bfloat16
    tr.run(10)
    saved = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    saved_opt = {k: {n: t.clone() for n, t in tr.opt_state[k].items()}
                 for k in ("master", "m", "v")}
    batch_11 = tr.data._gen(10)
    tr.run(5)
    assert tr.restore(10) == 10 and tr.step == 10
    for n, p in tr.model.named_parameters():
        assert p.dtype == saved[n].dtype
        assert torch.equal(p.detach().view(torch.int16)
                           if p.dtype == torch.bfloat16 else p.detach(),
                           saved[n].view(torch.int16)
                           if p.dtype == torch.bfloat16 else saved[n]), n
    for k, leaves in saved_opt.items():
        for n, t in leaves.items():
            assert torch.equal(tr.opt_state[k][n], t), (k, n)
    assert int(tr.opt_state["step"]) == 10
    assert next(tr.data)["tokens"].tobytes() == batch_11["tokens"].tobytes()


def test_checkpointer_keeps_bf16_bits(tmp_path):
    """bf16 leaves (every 16-bit pattern: NaNs, infinities, subnormals)
    come back bit for bit into a bf16 template; other leaves as before."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    state = {"w": bits.view(torch.bfloat16), "n": np.arange(3, dtype=np.int64),
             "f": torch.ones(2, dtype=torch.float32)}
    ckpt = Checkpointer(str(tmp_path), keep=1)
    ckpt.save(1, state)
    got, step = ckpt.restore(
        {"w": torch.zeros(2 ** 16, dtype=torch.bfloat16),
         "n": np.zeros(3, np.int64), "f": torch.zeros(2)})
    assert step == 1 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), bits)
    assert got["n"].tolist() == [0, 1, 2] and got["f"].tolist() == [1.0, 1.0]


# --- the launcher and the device rule ------------------------------------------

def test_train_main_runs_on_cpu_and_needs_cuda_by_default(tmp_path, capsys):
    argv = ["--arch", "deepseek-moe-16b", "--smoke", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    tr = launch_train.main(argv, device="cpu")
    assert tr.step == 3 and len(tr.history) == 3
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in tr.history)
    assert tr.ckpt.latest_step() == 2
    assert "done at step 3" in capsys.readouterr().out
    # with no process group the production meshes raise, naming the
    # group they need, before a weight is built
    with pytest.raises(ValueError, match="256-rank process group"):
        launch_train.main(argv + ["--production-mesh"], device="cpu")
    with pytest.raises(ValueError, match="512-rank process group"):
        launch_train.main(argv + ["--multi-pod"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.Trainer(TT.TrainSetup(model=treg.get_config(
                "minicpm-2b-smoke"), opt=TO.OptConfig()), iter(()))


def test_kernel_entry_points_stay_differentiable_on_the_cpu():
    """On the CPU the kernels' wrappers run their plain versions, which
    autograd records (on CUDA they refuse a gradient: tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).requires_grad_()
    q, k, v = t(1, 8, 2, 16), t(1, 8, 1, 16), t(1, 8, 1, 16)
    x, Bm, Cm = t(1, 8, 2, 16), t(1, 8, 16), t(1, 8, 16)
    dt = torch.rand(1, 8, 2, requires_grad=True)
    A = torch.rand(2, requires_grad=True)
    a = torch.rand(1, 8, 4, requires_grad=True)
    b = t(1, 8, 4)
    outs = [fa_ops.flash_attention(q, k, v), ssd_ops.ssd_scan(x, dt, A, Bm, Cm),
            rglru_ops.rglru_scan(a, b)]
    grads = torch.autograd.grad(sum(o.sum() for o in outs),
                                [q, k, v, x, dt, A, Bm, Cm, a, b])
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


# --- the sharded train step on a real multi-rank mesh ------------------------
# (the ranks' bodies are in `torch_rank_jobs`, which imports no JAX, so
# the spawned ranks start without it)

SHARDED_STEPS = jobs.SHARDED_STEPS


def _param_gaps(named_port, ref_of, move):
    total = off = 0
    worst = 0.0
    for name, got in named_port.items():
        d = np.abs(got - ref_of(name))
        total += d.size
        off += int((d > 1e-5).sum())
        worst = max(worst, float(d.max()))
    assert off <= 1e-3 * total and worst <= move, (off, total, worst, move)
    return worst, off, total


def test_sharded_trainer_on_four_gloo_ranks_matches_the_reference(tmp_path):
    """minicpm-2b-smoke in fp32 through `Trainer(mesh=...)` on 4 gloo ranks
    in a (2, 2) mesh (data x model: FSDP-free at this size, the batch and
    the vocab-parallel embedding, heads and FFN split), 2 steps, against
    the reference's `make_train_step` on a 1 x 1 mesh from the same
    weights and batches: metrics 1e-5 relative; parameters 1e-5 absolute
    but for at most 1e-3 of the elements, and those within Adam's largest
    move (the phase-15 bar of `PERF.md` section 2)."""
    cfg, params, tcfg, model = _models("minicpm-2b")
    opt = JO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                       weight_decay=0.1, schedule=cfg.schedule)
    jstep = jax.jit(JT.make_train_step(
        JT.TrainSetup(model=cfg, opt=opt, attn_impl="chunked", remat=True),
        _mesh()))
    named = {n: _np(p) for n, p in model.named_parameters()}
    res = jobs.run_ranks(jobs.sharded_trainer, 4, tmp_path / "store",
                    (tcfg, _opt_config(opt), named, 2),
                    timeout=300)
    hist, full, placed, pspecs = res[0]
    assert all(r == placed if isinstance(r, int) else True for r in res)
    assert placed == len(named)
    assert any("model" in tuple(s) for s in pspecs.values())
    jopt = JO.init_opt_state(params)
    data = TD.SyntheticTokens(cfg.vocab_size, 4, 32, seed=3)
    jhist = []
    for _ in range(SHARDED_STEPS):
        batch = next(data)
        params, jopt, jm = jstep(params, jopt,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        jhist.append(jm)
    for tm, jm in zip(hist, jhist):
        for k in METRICS:
            assert _rel(tm[k], jm[k]) < 1e-5, k
    jparams = jax.tree.map(np.asarray, params)
    move = 2 * sum(float(h["lr"]) for h in hist)
    worst, off, total = _param_gaps(full, lambda n: _leaf(jparams, n), move)
    print(f"\nsharded (2, 2) vs reference: largest parameter gap {worst:.3e},"
          f" {off} of {total} elements above 1e-5")


@pytest.mark.parametrize("model_axis", [3, 4])
def test_sharded_trainer_with_heads_split_unevenly_matches_the_reference(
        tmp_path, model_axis):
    """minicpm-2b-smoke (4 query heads, 2 KV heads) in fp32 through
    `Trainer(mesh=...)` on a (1, m) mesh of gloo ranks, where "model"
    does not divide the KV heads (m 4: each rank one query head and its
    KV head) or either head count (m 3: two heads a rank, the last rank's
    second a padding head), 2 steps, against the reference's
    `make_train_step` on a 1 x 1 mesh: the phase-15 bar, as above."""
    cfg, params, tcfg, model = _models("minicpm-2b")
    opt = JO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                       weight_decay=0.1, schedule=cfg.schedule)
    jstep = jax.jit(JT.make_train_step(
        JT.TrainSetup(model=cfg, opt=opt, attn_impl="chunked", remat=True),
        _mesh()))
    named = {n: _np(p) for n, p in model.named_parameters()}
    hist, full, placed, _ = jobs.run_ranks(
        jobs.sharded_trainer, model_axis, tmp_path / "store",
        (tcfg, _opt_config(opt), named, model_axis), timeout=300)[0]
    assert placed == len(named)
    jopt = JO.init_opt_state(params)
    data = TD.SyntheticTokens(cfg.vocab_size, 4, 32, seed=3)
    for tm in hist:
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, jopt, jm = jstep(params, jopt, batch)
        for k in METRICS:
            assert _rel(tm[k], jm[k]) < 1e-5, k
    jparams = jax.tree.map(np.asarray, params)
    move = 2 * sum(float(h["lr"]) for h in hist)
    worst, off, total = _param_gaps(full, lambda n: _leaf(jparams, n), move)
    print(f"\nsharded (1, {model_axis}) vs reference: largest parameter "
          f"gap {worst:.3e}, {off} of {total} elements above 1e-5")


@pytest.mark.parametrize("world,model_axis", [(4, 2), (3, 3)],
                         ids=["2x2", "1x3"])
def test_sharded_mamba2_trainer_matches_the_reference(tmp_path, world,
                                                      model_axis):
    """mamba2-780m-smoke (8 SSD heads) in fp32 through `Trainer(mesh=...)`
    on gloo ranks: on (2, 2) the batch over "data" (the SSD weights'
    gradients summed over the data shards) and 4 heads a rank over
    "model"; on (1, 3) 3 heads a rank, the last rank's third a padding
    head.  2 steps against the reference's `make_train_step` on a 1 x 1
    mesh: the phase-15 bar, as above."""
    cfg, params, tcfg, model = _models("mamba2-780m")
    opt = JO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                       weight_decay=0.1, schedule=cfg.schedule)
    jstep = jax.jit(JT.make_train_step(
        JT.TrainSetup(model=cfg, opt=opt, attn_impl="chunked", remat=True),
        _mesh()))
    named = {n: _np(p) for n, p in model.named_parameters()}
    hist, full, placed, _ = jobs.run_ranks(
        jobs.sharded_trainer, world, tmp_path / "store",
        (tcfg, _opt_config(opt), named, model_axis), timeout=300)[0]
    assert placed == len(named)
    jopt = JO.init_opt_state(params)
    data = TD.SyntheticTokens(cfg.vocab_size, 4, 32, seed=3)
    for tm in hist:
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, jopt, jm = jstep(params, jopt, batch)
        for k in METRICS:
            assert _rel(tm[k], jm[k]) < 1e-5, k
    jparams = jax.tree.map(np.asarray, params)
    move = 2 * sum(float(h["lr"]) for h in hist)
    worst, off, total = _param_gaps(full, lambda n: _leaf(jparams, n), move)
    print(f"\nsharded mamba2 ({world // model_axis}, {model_axis}) vs "
          f"reference: largest parameter gap {worst:.3e}, {off} of {total} "
          "elements above 1e-5")


def test_sharded_step_on_one_rank_equals_the_plain_step(tmp_path):
    """On a 1 x 1 mesh every placement is replicated and no collective
    runs: the sharded step equals the plain one (metrics and parameters
    equal; the largest difference is printed), its checkpoint holds the
    same arrays as the plain one's, and restoring it brings the sharded
    trainer back to them."""
    tcfg = dataclasses.replace(treg.get_config("minicpm-2b-smoke"),
                               dtype="float32")
    opt = JO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                       weight_decay=0.1, schedule=tcfg.schedule)
    hs, hp, gap, same, back = jobs.run_ranks(
        jobs.one_rank_trainer, 1, tmp_path / "store",
        (tcfg, _opt_config(opt), str(tmp_path / "ckpt")), timeout=180)[0]
    print(f"\none-rank mesh vs plain: largest parameter difference {gap}")
    assert hs == hp
    assert gap == 0.0
    assert same
    assert back == 0.0


def test_train_main_on_a_host_mesh_equals_one_device(tmp_path,
                                                    monkeypatch):
    """`launch.train.main` on 2 gloo ranks trains on `make_host_mesh(model
    =1)` and equals its one-device run at the phase-15 bar, both with the
    smoke config in fp32 (metrics 1e-5 relative; parameters 1e-5, or
    within Adam's largest move for at most 1e-3 of the elements);
    `--production-mesh` on that group raises, naming the 256 ranks it
    needs."""
    lr = 1e-3
    argv = ["--arch", "minicpm-2b", "--smoke", "--steps", "3", "--batch",
            "4", "--seq", "32", "--lr", str(lr), "--ckpt-every", "0",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    res = jobs.run_ranks(jobs.launcher, 2, tmp_path / "store", (argv,),
                         timeout=240)
    hist, full, placed, err = res[0]
    assert placed > 0
    assert "256-rank process group" in err and "2 ranks" in err
    assert res[1] == err
    monkeypatch.setattr(launch_train, "get_config",
                        jobs.fp32_configs(launch_train.get_config))
    tr = launch_train.main(argv, device="cpu")
    assert len(hist) == len(tr.history) == 3
    for hm, pm in zip(hist, tr.history):
        for k in pm:
            assert _rel(hm[k], pm[k]) < 1e-5, k
    plain = {n: p.detach().numpy() for n, p in tr.model.named_parameters()}
    worst, off, total = _param_gaps(full, plain.__getitem__, 3 * lr)
    print(f"\nlauncher on a (2, 1) host mesh vs one device: largest "
          f"parameter gap {worst:.3e}, {off} of {total} elements above "
          f"1e-5")


def test_jit_train_step_places_on_first_call_and_keeps_specs():
    """`jit_train_step(...)(model, opt)` exposes the three spec trees and
    places nothing before its first call (on a fake 8-rank mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.dryrun import fake_group
    tcfg = treg.get_config("minicpm-2b-smoke")
    with fake_group(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        model = TTF.Transformer(tcfg, "cpu")
        opt = TO.init_opt_state(model)
        shapes = {"tokens": torch.empty(8, 16, dtype=torch.int32),
                  "labels": torch.empty(8, 16, dtype=torch.int32)}
        build = TT.jit_train_step(TT.TrainSetup(model=tcfg,
                                                opt=TO.OptConfig()),
                                  mesh, shapes)
        step = build(model, opt)
        pspecs, ospecs, bspecs = step.pspec_tree
        assert build.pspec_tree is step.pspec_tree
        assert pspecs["embed"][0] == "model"
        assert ospecs["step"] == () and set(ospecs) == {"master", "m", "v",
                                                        "step"}
        assert bspecs["tokens"][0] == "data"
        assert not any(isinstance(p, DTensor) for p in model.parameters())
        TT.place_model(model, pspecs, mesh)
        TT.place_tree(opt, ospecs, mesh)
        assert all(isinstance(p, DTensor) for p in model.parameters())
        assert tuple(opt["m"]["embed"].to_local().shape) \
            == (256 // 4, 64 // 2)


def test_sharded_moe_loss_and_gradients_match_the_plain_path(tmp_path):
    """deepseek-moe-16b-smoke in fp32 on 4 gloo ranks, a (2, 2) mesh:
    the experts split over "model" (expert parallelism), each data shard
    routing its own tokens.  With a capacity no pair overflows, each
    shard's routing is the global one's, and the load-balance factors
    are summed over the shards before their product, so the loss, its
    nll and aux, and every gradient equal the plain path's on the whole
    batch (3e-5 relative to each leaf's largest value)."""
    base = treg.get_config("deepseek-moe-16b-smoke")
    tcfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, capacity_factor=float(base.moe.num_experts)))
    batch = _batch(tcfg, 4, 32, seed=6)
    out, full, placements = jobs.run_ranks(
        jobs.moe_sharded_grads, 4, tmp_path / "store",
        (tcfg, batch["tokens"], batch["labels"]), timeout=300)[0]
    assert all("Shard(dim=0)" in p for p in placements)
    model = TTF.init_params(tcfg, torch.Generator().manual_seed(7), "cpu")
    params = dict(model.named_parameters())
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    ref, met = TTF.lm_loss(model, tcfg, batch, attn_impl="chunked")
    grads = torch.autograd.grad(ref, list(params.values()))
    assert _rel(out["nll"], _np(met["nll"])) < 1e-5
    assert _rel(out["aux"], _np(met["aux"])) < 1e-5
    assert _rel(out["loss"], _np(ref)) < 1e-5
    for (name, _), g in zip(params.items(), grads):
        assert _rel(full[name], _np(g)) < 3e-5, name


def test_sharded_moe_trainer_on_four_gloo_ranks_matches_the_reference(
        tmp_path):
    """deepseek-moe-16b-smoke in fp32 on 4 gloo ranks in a (2, 2) mesh
    (experts over "model", tokens over "data"), from the reference's
    weights, at a capacity no pair overflows: the loss, nll, aux and every
    gradient of the first batch against `jax.value_and_grad` of the loss
    that the reference's `make_train_step` differentiates (1e-5 relative;
    gradients 3e-5 relative to each leaf's largest value), then
    `Trainer(mesh=...)`'s 2 steps against `make_train_step` on a 1 x 1
    mesh: metrics 1e-5 relative, parameters within the phase-15 bar."""
    cfg, params, tcfg, model = _models("deepseek-moe-16b")

    def roomy(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.num_experts)))
    cfg, tcfg = roomy(cfg), roomy(tcfg)
    opt = JO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                       weight_decay=0.1, schedule=cfg.schedule)
    setup = JT.TrainSetup(model=cfg, opt=opt, attn_impl="chunked",
                          remat=True)
    jstep = jax.jit(JT.make_train_step(setup, _mesh()))
    named = {n: _np(p) for n, p in model.named_parameters()}
    first, grads, hist, full = jobs.run_ranks(
        jobs.moe_sharded_against_reference, 4, tmp_path / "store",
        (tcfg, _opt_config(opt), named), timeout=300)[0]

    data = TD.SyntheticTokens(cfg.vocab_size, 4, 32, seed=3)
    batch = {k: jnp.asarray(v) for k, v in next(data).items()}
    constrain = JSH.make_constrain(_mesh())
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.lm_loss(p, cfg, batch, attn_impl="chunked",
                              remat=True, constrain=constrain),
        has_aux=True))(params)
    assert _rel(first["loss"], jl) < 1e-5
    for k in ("nll", "aux"):
        assert _rel(first[k], jm[k]) < 1e-5, k
    assert float(jm["aux"]) > 0
    jg = jax.tree.map(np.asarray, jg)
    for name, g in grads.items():
        assert _rel(g, _leaf(jg, name)) < 3e-5, name

    jopt = JO.init_opt_state(params)
    data = TD.SyntheticTokens(cfg.vocab_size, 4, 32, seed=3)
    jhist = []
    for _ in range(SHARDED_STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(data).items()}
        params, jopt, jm = jstep(params, jopt, batch)
        jhist.append(jm)
    for tm, jm in zip(hist, jhist):
        for k in METRICS:
            assert _rel(tm[k], jm[k]) < 1e-5, k
    jparams = jax.tree.map(np.asarray, params)
    move = 2 * sum(float(h["lr"]) for h in hist)
    worst, off, total = _param_gaps(full, lambda n: _leaf(jparams, n), move)
    print(f"\nsharded MoE (2, 2) vs reference: largest parameter gap "
          f"{worst:.3e}, {off} of {total} elements above 1e-5")
