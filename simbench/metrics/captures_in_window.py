"""CUDA graphs captured inside the window (`graphs.captures()` before and
after the timed jobs); the set-up's warm job leaves none to make."""


def read(ctx):
    return ctx.captures_in_window
