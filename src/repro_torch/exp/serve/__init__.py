"""repro_torch.exp.serve: a persistent, multi-tenant simulation service
(port of `repro.exp.serve`).

Submitted `ExperimentSpec`s are bucketed by graph signature
(`scheduler.BucketKey`), packed into device-filling windowed dispatches
(`packer.Pack` over `LaneSession`s, ghost-padded, tenant-fair), streamed
as JSONL window/result records (`repro_torch.exp.windows` — the
reference's schema, shared with `python -m repro_torch.exp.run --jsonl`),
and checkpointed/resumed bit for bit through `repro_torch.checkpoint`.

    from repro_torch.exp.serve import SimService
    svc = SimService(out="serve.jsonl")            # on CUDA
    rid = svc.submit(get_scenario("smoke"))
    svc.run()

CLI: ``python -m repro_torch.exp.serve --inbox specs/ --out serve.jsonl``.
"""
from .scheduler import (BucketKey, LaneUnit, Scheduler, bucket_cfg,
                        bucket_sweep, clear_serve_caches, lower_request)
from .packer import Pack
from .service import SimService, serve_pack, serve_window

__all__ = [
    "BucketKey", "LaneUnit", "Pack", "Scheduler", "SimService",
    "bucket_cfg", "bucket_sweep", "clear_serve_caches", "lower_request",
    "serve_pack", "serve_window",
]
