"""gflops: the canonical work of the calls the window finished (2·nnzCt
of each call's products, ``Driver.work``), over the window's seconds, from
its start on the host clock to the synchronize of its last call."""


def read(ctx):
    return ctx.calls * ctx.work.flops / ctx.window_s / 1e9
