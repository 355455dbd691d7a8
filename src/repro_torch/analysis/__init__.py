"""Static verification + lint for the PyTorch port (port of
`repro.analysis`).

Six passes; only the step pass runs a cycle, one superstep a cell:

  spec     (`specpass`)    per-scenario proofs from the declarative
           spec: VC-scheme resolution, per-epoch CDG deadlock freedom on
           the port's route kernels (on the chosen device),
           fault-schedule routability, and the grant form the reference
           would take.  Reference: `repro.analysis.specpass`, same rules.
  compile  (`compilepass`) the capture signature of each grid — the key
           `graphs.graph_for` caches a CUDA graph under, built on the
           `meta` device — and the graphs `run_experiment` makes: the
           one-capture-per-grid promise.  Reference: the compile-signature
           pass `repro.analysis.compilepass` (one XLA compile a grid),
           same rule ids.
  capacity (`capacitypass`) interval analysis of the compact step's
           capacity ladder and the superstep/epoch interaction.
           Reference: `repro.analysis.capacitypass`, same rules.
  step     (`steppass`)    one superstep of every (step, VC mode,
           fault kind) cell as a graph replays it: carry stability (what
           `graphs.copy_state` needs), no 64-bit fields, the operation
           count, and the batch-purity probe of the route kernels.
           Reference: the jaxpr pass `repro.analysis.jaxprpass`
           (JAXPR_CARRY -> STEP_CARRY, JAXPR_DTYPE -> STEP_DTYPE,
           JAXPR_BATCH -> STEP_BATCH, JAXPR_TRACE -> STEP_TRACE;
           JAXPR_OOB has no counterpart).
  serve    (`servepass`)   the service's one-capture-per-bucket promise
           and the graphs its sessions make.  Reference:
           `repro.analysis.servepass`, same rules.
  lint     (`lint`)        AST rules REPRO001-004 with their torch
           meanings (REPRO003: a host sync in a step body; REPRO004 over
           the port's example scripts) and REPRO005 (no jax / reference
           imports).  Reference: `repro.analysis.lint`.

CLI: `python -m repro_torch.analysis.check --all --lint --serve` (exits
nonzero on any unsuppressed error or warning; `--device` defaults to
CUDA).  Suppressions live exclusively in `allowlist.DEFAULT_ENTRIES`
(empty) or an `--allowlist` file — there is no inline escape hatch.
"""
from .allowlist import AllowEntry, Allowlist
from .findings import Finding, Report

__all__ = ["AllowEntry", "Allowlist", "Finding", "Report"]
