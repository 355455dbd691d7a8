"""The LM stack (port of `repro.models`): layers, the transformer and
the weight converter from the reference."""
