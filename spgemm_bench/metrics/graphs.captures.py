"""graphs.captures: the CUDA graphs the program's cache
(``ops/graphs.captures``) captured during the window. A plan that repeats
replays, so a capture in the window is a recapture or a new plan."""


def read(ctx):
    return float(ctx.captures)
