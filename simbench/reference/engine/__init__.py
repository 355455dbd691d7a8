"""The oracle cycle step, phase by phase (`step.make_step`)."""
