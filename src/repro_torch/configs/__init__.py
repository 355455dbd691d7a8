"""Model and run configurations (port of `repro.configs`)."""
