"""The benchmark of the PyTorch/CUDA port's network simulator
(`repro_torch`): see README.md beside this file."""
