"""Launchers (port of `repro.launch`): serving and training."""
