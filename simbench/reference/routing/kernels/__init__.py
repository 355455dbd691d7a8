"""Route kernels, one module per scheme.

Every kernel obeys the `RoutePipeline` calling convention
``kernel(fl, cur, dest_term, mis_wg, meta)``: row arguments are
``[B, N]`` tensors with a leading lane dimension, and the fault-dependent
tables `fl` are lane-stacked ``[B, ...]``.  A kernel only gathers; it never
reduces over or reshapes its row arguments, so lanes stay independent.
"""
from .baseline import make_baseline_kernel
from .updown import make_updown_kernel
from .dragonfly import make_dragonfly_kernel

__all__ = ["make_baseline_kernel", "make_updown_kernel",
           "make_dragonfly_kernel"]
