"""A synthetic web-graph matrix: pages grouped into hosts, power-law
out-degrees, links drawn by page kind.

- Hosts are runs of consecutive page ids (a crawl ordered by URL) with
  power-law sizes, P(size = s) ~ s^-``host_alpha`` on [1, ``host_max``].
- Out-degrees are power-law, P(d) ~ d^-``alpha`` on [1, ``max_deg``], and
  within a host in decreasing order: the host's first page is its
  longest (a directory), the next ``hubs`` pages are its hubs (home and
  navigation pages), the rest are its ordinary pages.
- An ordinary page's or a directory's link goes to one of its host's hubs
  with probability ``nav``, to any page of its host with probability
  ``local``, and otherwise to any page of the graph with probability
  growing with that page's out-degree, d^``beta``.
- A hub draws every link from one pool its host's hubs share, of
  ``pool`` times the largest hub's out-degree, made the same way
  (host pages with probability ``local``, else by d^``beta``). So hubs of
  one host hold near-equal link sets, and a page that links to several
  of them adds the same columns of C more than once: the products per
  entry of C (about 1.36 in webbase-1M) come from that.

Repeated links are merged; then every entry gets a standard-normal
float32 value. Returns host arrays ``(rowptr, colidx, vals, shape)`` in
canonical CSR order (sorted columns, no duplicates). The same parameters
give the same matrix.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# the size the benchmark's CPU tests cut a configuration of this generator
# to (``tests/conftest.make_small_root``): the same exponents and link
# shares on 4,096 rows, hosts and degrees capped at n; 12,711 nnz and
# 119,990 products, enough that the dispatcher picks grouped, as at the
# full size
SMALL_PARAMS = {"n": 4096, "alpha": 2.22, "max_deg": 4096,
                "host_alpha": 1.8, "host_max": 4096, "hubs": 8, "nav": 0.25,
                "local": 0.55, "beta": 0.5, "pool": 0.2, "seed": 0}


def _power_law(rng, size: int, alpha: float, hi: int) -> np.ndarray:
    """``size`` draws of P(k) ~ k^-alpha on [1, hi] (inverse CDF)."""
    a1 = 1.0 - alpha
    top = float(hi + 1) ** a1
    k = np.floor((1.0 + rng.random(size) * (top - 1.0)) ** (1.0 / a1))
    return np.clip(k, 1, hi).astype(np.int64)


def generate(n: int, alpha: float, max_deg: int, host_alpha: float,
             host_max: int, hubs: int, nav: float, local: float,
             beta: float, pool: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    # hosts: runs of consecutive ids, the last one cut to end at n
    sizes = _power_law(rng, n, host_alpha, host_max)
    ends = np.cumsum(sizes)
    k = int(np.searchsorted(ends, n)) + 1
    sizes = sizes[:k].copy()
    sizes[-1] = n - (int(ends[k - 2]) if k > 1 else 0)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    host = np.repeat(np.arange(k), sizes)
    # out-degrees, longest first within each host
    deg = _power_law(rng, n, alpha, max_deg)
    deg = deg[np.lexsort((-deg, host))]
    rank = np.arange(n) - starts[host]
    n_hubs = np.minimum(sizes - 1, hubs)
    is_hub = (rank >= 1) & (rank <= n_hubs[host])

    weight = np.cumsum(deg.astype(np.float64) ** beta)

    def by_degree(size: int) -> np.ndarray:
        return np.minimum(np.searchsorted(
            weight, rng.random(size) * weight[-1], "right"), n - 1)

    def in_host(h: np.ndarray) -> np.ndarray:
        return starts[h] + (rng.random(h.size) * sizes[h]).astype(np.int64)

    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    h = host[rows]
    u = rng.random(rows.size)
    to_hub = starts[h] + np.minimum(
        1 + (rng.random(rows.size) * n_hubs[h]).astype(np.int64),
        sizes[h] - 1)
    cols = np.where(u < nav, to_hub,
                    np.where(u < nav + local, in_host(h),
                             by_degree(rows.size)))
    # the hubs' shared pools
    top_hub = deg[np.minimum(starts + 1, n - 1)] * (sizes > 1)
    pool_size = np.ceil(pool * top_hub).astype(np.int64)
    pool_start = np.concatenate([[0], np.cumsum(pool_size)[:-1]])
    ph = np.repeat(np.arange(k), pool_size)
    pooled = np.where(rng.random(ph.size) < local, in_host(ph),
                      by_degree(ph.size))
    pick = pool_start[h] + (rng.random(rows.size)
                            * pool_size[h]).astype(np.int64)
    hub_rows = is_hub[rows]
    cols[hub_rows] = pooled[pick[hub_rows]]

    pattern = sp.coo_matrix(
        (np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n)).tocsr()
    pattern.sum_duplicates()
    pattern.sort_indices()
    vals = rng.standard_normal(pattern.nnz).astype(np.float32)
    return pattern.indptr, pattern.indices, vals, (n, n)
