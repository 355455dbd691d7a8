"""Train, prefill and decode steps (one device, or sharded on a mesh),
the host training loop and its fault tolerance, the sharding rules and
the collective accounting (port of `repro.runtime`)."""
