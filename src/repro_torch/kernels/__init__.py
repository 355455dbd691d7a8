"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the reference (`repro.kernels`), each with a plain PyTorch version
(`ref`), an engine-facing wrapper (`ops`) and its CUDA sources
(`csrc/`), built by `build`."""
