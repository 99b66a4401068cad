"""setup_s: from the process's start to the window's: imports, the
inputs, the kernels' build (the first run in a checkout), the program's
plans and the warm-up."""


def read(ctx):
    return ctx.setup_s
