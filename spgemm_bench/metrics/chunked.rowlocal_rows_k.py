"""chunked.rowlocal_rows_k: the thousands of rows a chunked call hands to
the row-local kernel K6, by the program's counter ``chunked.rowlocal_rows``
(``ops/chunked.spgemm_chunked``: A's rows on the row-local route, every
call). Nothing where the counter reads 0 or nothing: a call on the product
stream, a program without the route, or a run untraced."""
from spgemm_bench import recorded


def read(ctx):
    rows = recorded.per_call(recorded.counter("chunked.rowlocal_rows"), ctx)
    if not rows:
        return None
    return rows / 1e3
