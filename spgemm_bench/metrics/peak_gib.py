"""peak_gib: ``torch.cuda.max_memory_reserved()`` over the run, read once
the window has closed: the caching allocator's reserve, the CUDA graphs'
pool included (``max_memory_allocated`` does not see the pool)."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2**30
