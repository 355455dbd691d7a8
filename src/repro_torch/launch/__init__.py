"""Launchers (port of `repro.launch`): so far the serving launcher."""
