"""Quickstart on the PyTorch/CUDA port: build the paper's switch-less
Dragonfly, check the analytical model, and run a small simulation through
the declarative experiment API (steps 1-2 of `examples/quickstart.py`,
with the same spec; on the GPU the sweep's grant runs as the netsim CUDA
kernel).  Its step 3, pricing a training step on the wafer fabric, needs
the roofline of `benchmarks/roofline.py`, which the port does not have
yet.

Run from the repo root (after `pip install -e .`, or with
`PYTHONPATH=src`):

    python -m examples.torch_quickstart                  # on the GPU
    python -m examples.torch_quickstart --device cpu
"""
import argparse

from repro_torch.core import analytical as A
from repro_torch.core import topology as T
from repro_torch.device import resolve_device
from repro_torch.exp import (ExperimentSpec, RoutingSpec, SweepAxes,
                             TopologySpec, TrafficSpec, run_experiment)


def quickstart_spec() -> ExperimentSpec:
    """Step 2's experiment: one C-group under uniform traffic, three
    offered loads, 300 + 900 cycles (the reference script's spec)."""
    return ExperimentSpec(
        name="quickstart",
        topologies=TopologySpec.switchless(a=1, b=1, m=2, n=6, noc=2, g=1,
                                           label="cgroup"),
        traffics=TrafficSpec("uniform"),
        routings=RoutingSpec(vcs_per_class=4),
        axes=SweepAxes(rates=(1.0, 2.0, 3.0), warmup=300, measure=900))


def main(argv=None, device=None) -> list:
    """The reference script's output for steps 1-2, on `device` (the
    `--device` flag; CUDA when neither names one).  Returns step 2's
    rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or device)

    # 1. the paper's radix-16 evaluation network
    params = T.paper_radix16_switchless()
    print("== Switch-less Dragonfly (radix-16 eval config) ==")
    for k, v in A.summarize(params).items():
        print(f"  {k:10s} = {v}")

    # 2. a declarative experiment: one C-group under uniform traffic.
    # The spec is plain data (hashable, JSON round-trippable); the runner
    # runs the whole load-latency curve as ONE batched dispatch, on the
    # GPU one captured CUDA graph.
    spec = quickstart_spec()
    net = spec.topologies[0].build()
    print(f"\n== intra-C-group simulation ({net.num_nodes} routers) ==")
    result = run_experiment(spec, device=dev)
    rows = result.rows()
    for rec in rows:
        print(f"  offered {rec['offered']:.1f} flits/cyc/chip -> accepted "
              f"{rec['throughput']:.2f}, latency {rec['latency']:.1f} cyc")
    print(f"  (paper Fig. 10(a): saturation ~3.0; "
          f"compiles={result.compile_counts})")

    print("\n(step 3, minicpm-2b train_4k priced on a 256-chip wafer pod, "
          "waits for the port of benchmarks/roofline.py)")
    return rows


if __name__ == "__main__":
    main()
