"""The PyTorch port's whole-stream run-sum + compaction
(``ops/stream.runsum_compact_scan``) against the reference's
block-by-block ``lax.scan`` (its ops/scancompact), and against a plain
NumPy run-sum.

Keys, tail counts and compacted keys must be equal; run sums agree within
rtol 1e-5 / atol 1e-6 (float32 sums of up to max_run terms, added in a
different order), and bit for bit where the values are small integers."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmark_spgemm_using_csr_tpu.ops.scancompact import (
    SENTINEL_U32 as J_SENTINEL,
    runsum_compact_scan as j_scan,
)
from benchmark_spgemm_using_csr_tpu_torch.ops.stream import (
    SENTINEL_U32,
    runsum_compact_scan,
)

torch.set_num_threads(2)


def grouped_stream(rng, g: int, w: int, fill: float, nkeys: int):
    """g groups of w slots, each sorted, sentinel-padded past its fill;
    nkeys small -> long duplicate runs that straddle scan blocks; equal
    keys in neighbouring groups must not merge across the boundary."""
    key = np.full((g, w), J_SENTINEL, np.uint32)
    for gi in range(g):
        n = int(w * fill * rng.random())
        key[gi, :n] = np.sort(rng.integers(0, nkeys, size=n)).astype(np.uint32)
    if g > 1:  # same key at the end of group 0 and the start of group 1
        key[0, -3:] = 7
        key[1, :3] = 7
        key[1].sort()
        key[0].sort()
    val = rng.standard_normal((g, w)).astype(np.float32)
    val[key == J_SENTINEL] = 0
    return key.reshape(-1), val.reshape(-1)


@pytest.mark.parametrize("g,w,block,nkeys,max_run", [
    (4, 100, 16, 8, 64),  # w not a multiple of block; runs straddle blocks
    (3, 256, 64, 40, 32),
    (1, 1000, 128, 3, 512),  # one group, very long runs
    (8, 64, 64, 1000, 4),  # few duplicates
])
def test_matches_reference_scan(g, w, block, nkeys, max_run):
    rng = np.random.default_rng(g * w + nkeys)
    key, val = grouped_stream(rng, g, w, 0.9, nkeys)
    out_cap = g * w
    jk, jv, jt = (np.asarray(x) for x in j_scan(
        jnp.asarray(key), jnp.asarray(val), w=w, out_cap=out_cap,
        max_run=max_run, block=block))
    tk, tv, tt = runsum_compact_scan(
        torch.from_numpy(key.astype(np.int64)), torch.from_numpy(val),
        w=w, out_cap=out_cap, max_run=max_run)
    np.testing.assert_array_equal(tt.numpy(), jt)
    n = int(jt[-1])
    np.testing.assert_array_equal(tk.numpy()[:n], jk[:n].view(np.uint32))
    np.testing.assert_allclose(tv.numpy()[:n], jv[:n], rtol=1e-5, atol=1e-6)
    assert (tk.numpy()[n:] == 0).all()


def numpy_runsum(okey, val, w: int, out_cap: int):
    """The plain run-sum: runs of equal keys within one w-slot group,
    summed left to right; the valid runs' keys and sums compacted; the
    inclusive count of run tails."""
    s = okey.size
    gid = np.arange(s) // w
    head = np.ones(s, bool)
    head[1:] = (okey[1:] != okey[:-1]) | (gid[1:] != gid[:-1])
    starts = np.flatnonzero(head)
    sums = np.add.reduceat(val, starts)
    tail = np.zeros(s, bool)
    tail[np.append(starts[1:], s) - 1] = True
    kept = tail & (okey != J_SENTINEL)
    live = okey[starts] != J_SENTINEL
    keyc = np.zeros(out_cap, np.int64)
    valc = np.zeros(out_cap, np.float32)
    n = int(kept.sum())
    keyc[:n] = okey[starts][live]
    valc[:n] = sums[live]
    return keyc, valc, np.cumsum(kept)


@pytest.mark.parametrize("g,w_over,nkeys", [
    (1, 0, 3),  # one group, w == S: no group id
    (1, 5, 40),  # one group, w > S
    (3, 0, 8),  # three sorted runs read as one group: runs cross them
    (4, None, 8),  # four groups of w: the group id cuts equal keys apart
    (8, None, 1000),
])
def test_one_group_matches_numpy_bit_for_bit(g, w_over, nkeys):
    """One-group streams (w >= S) compare keys alone; grouped ones (w < S)
    keep the group id. Small-integer float32 values make every summation
    order exact, so keys, sums and tails_cum are held bit for bit."""
    rng = np.random.default_rng(31 * g + nkeys)
    w0 = 96
    key, _ = grouped_stream(rng, g, w0, 0.9, nkeys)
    s = key.size
    if w_over is not None:  # one group: the whole stream, sorted
        key = np.sort(key)
    w = w0 if w_over is None else s + w_over
    val = rng.integers(-4, 5, size=s).astype(np.float32)
    val[key == J_SENTINEL] = 0
    want_k, want_v, want_t = numpy_runsum(key.astype(np.int64), val, w, s)
    tk, tv, tt = runsum_compact_scan(
        torch.from_numpy(key.astype(np.int64)), torch.from_numpy(val),
        w=w, out_cap=s, max_run=s)
    np.testing.assert_array_equal(tt.numpy(), want_t)
    np.testing.assert_array_equal(tk.numpy(), want_k)
    assert tv.numpy().tobytes() == want_v.tobytes()


def test_sentinel_is_the_reference_one():
    assert SENTINEL_U32 == int(J_SENTINEL) == 2**32 - 1


def test_large_nonaligned_groups_content():
    """The reference's >2^23-slot regression shape (9.43M slots, group
    width 131040, 64 local rows per group) as a content test: tails,
    compacted keys and run sums against numpy."""
    rng = np.random.default_rng(7)
    w, g = 131040, 72
    key2 = np.full((g, w), J_SENTINEL, np.uint32)
    for gi in range(16):
        fill = int(rng.integers(15800, w // 8))
        lrs = np.sort(rng.integers(0, 64, size=fill).astype(np.uint64))
        cols = rng.integers(0, 65536, size=fill).astype(np.uint64)
        key2[gi, :fill] = np.sort((lrs << 16) | cols).astype(np.uint32)
    okey = np.sort(key2, axis=1).reshape(-1)
    val = np.where(okey != J_SENTINEL, 1.0, 0.0).astype(np.float32)

    s = okey.size
    gid = np.arange(s) // w
    valid = okey != J_SENTINEL
    nxt = np.zeros(s, bool)
    nxt[:-1] = (okey[1:] == okey[:-1]) & (gid[1:] == gid[:-1])
    kept = valid & ~nxt
    want_cum = np.cumsum(kept)
    head = np.ones(s, bool)
    head[1:] = ~((okey[1:] == okey[:-1]) & (gid[1:] == gid[:-1]))
    starts = np.flatnonzero(head)
    run_len = np.diff(np.append(starts, s))[valid[starts]]

    tk, tv, tt = runsum_compact_scan(
        torch.from_numpy(okey.astype(np.int64)), torch.from_numpy(val),
        w=w, out_cap=s, max_run=2048)
    np.testing.assert_array_equal(tt.numpy(), want_cum)
    n = int(want_cum[-1])
    np.testing.assert_array_equal(tk.numpy()[:n], okey[kept])
    # unit values: each run sum is the run length, exact in float32
    np.testing.assert_array_equal(tv.numpy()[:n], run_len.astype(np.float32))
