"""The port's example drivers (`examples/torch_*.py`) on the CPU, held to
the reference's scripts beside them: the quickstart's spec is the
reference script's and its rows equal the reference runner's; the serve
driver's greedy tokens equal `examples/serve_lm.py`'s with the
reference's `PRNGKey(0)` weights carried over by `params_from_jax`; the
train driver at a tiny width lowers the nll, and with an injected
failure restarts from its snapshot and completes.
"""
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from examples import torch_quickstart  # noqa: E402
from examples import torch_serve_lm, torch_train_lm  # noqa: E402
from repro import exp as RX  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.exp import clear_caches  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)


def test_quickstart_rows_equal_the_reference(capsys):
    """The reference script's spec, written out as its `main` builds it,
    is the port's; the port's rows equal the reference runner's on it,
    wall time aside."""
    spec = RX.ExperimentSpec(
        name="quickstart",
        topologies=RX.TopologySpec.switchless(a=1, b=1, m=2, n=6, noc=2,
                                              g=1, label="cgroup"),
        traffics=RX.TrafficSpec("uniform"),
        routings=RX.RoutingSpec(vcs_per_class=4),
        axes=RX.SweepAxes(rates=(1.0, 2.0, 3.0), warmup=300, measure=900))
    port_spec = torch_quickstart.quickstart_spec()
    assert RX.ExperimentSpec.from_dict(port_spec.to_dict()) == spec
    ref = RX.run_experiment(spec).rows()
    clear_caches()
    got = torch_quickstart.main(["--device", "cpu"])
    strip = lambda rows: [{k: v for k, v in r.items() if k != "wall_s"}
                          for r in rows]
    assert strip(got) == strip(ref)
    out = capsys.readouterr().out
    assert "== intra-C-group simulation (16 routers) ==" in out
    assert "compiles=[1]" in out and "benchmarks/roofline.py" in out


def test_quickstart_needs_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_quickstart.main([])


def test_serve_tokens_equal_the_reference_script(monkeypatch, capsys):
    """`examples/serve_lm.py` at minicpm-2b-smoke, batch 2, prompt 16, 4
    tokens, against the port's `serve` on the same weights."""
    from examples import serve_lm
    monkeypatch.setattr(sys, "argv", ["serve_lm", "--batch", "2",
                                      "--prompt-len", "16", "--gen", "4"])
    serve_lm.main()
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("generated token ids"))
    want = [int(x) for x in re.findall(r"-?\d+", line.split(":", 1)[1])]
    assert len(want) == 4
    jcfg = jax_get_config("minicpm-2b-smoke")
    cfg = get_config("minicpm-2b-smoke")
    model = params_from_jax(JTF.init_params(jax.random.PRNGKey(0), jcfg),
                            cfg, device="cpu")
    tokens, _, _ = torch_serve_lm.serve(model, cfg, 2, 16, 4, "cpu")
    assert tokens.shape == (2, 4) and tokens.dtype == torch.int32
    assert tokens[0].tolist() == want
    # the command line runs end to end on the port's own seeded weights
    got = torch_serve_lm.main(["--batch", "2", "--prompt-len", "16",
                               "--gen", "4", "--device", "cpu"])
    assert got.shape == (2, 4)
    assert capsys.readouterr().out.rstrip().endswith("OK")


TINY_TRAIN = ["--d-model", "64", "--layers", "2", "--batch", "2", "--seq",
              "16", "--steps", "24", "--device", "cpu"]


def test_train_lowers_nll_and_recovers_from_a_failure(tmp_path, capsys):
    tr = torch_train_lm.main(TINY_TRAIN + ["--ckpt-dir",
                                           str(tmp_path / "plain")])
    nll = [h["nll"] for h in tr.history]
    assert len(nll) == 24 and np.mean(nll[-10:]) < np.mean(nll[:10])
    assert tr.ckpt.list_steps() == []          # every 50 steps: none yet
    tr = torch_train_lm.main(TINY_TRAIN + [
        "--ckpt-dir", str(tmp_path / "failed"), "--inject-failure-at", "15",
        "--ckpt-every", "10"])
    assert tr.step == 24 and tr.ckpt.list_steps() == [10, 20]
    # steps 11-15 ran twice: before the failure and after the restart
    assert len(tr.history) == 29
    out = capsys.readouterr().out
    assert "'resumed_step': 10" in out and out.rstrip().endswith("OK")
