"""paced.host.syncs: the times a call of a host-paced cell blocks the
host on the device, by the program's counter ``host.syncs`` (a host
copy, a scalar read, a shape-dependent op such as a boolean mask)."""
from spgemm_bench import recorded


def read(ctx):
    return recorded.per_call(recorded.counter("host.syncs"), ctx)
