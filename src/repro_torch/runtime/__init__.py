"""Train, prefill and decode steps, the host training loop and its fault
tolerance (port of `repro.runtime`; sharding and HLO analysis are not
ported yet)."""
