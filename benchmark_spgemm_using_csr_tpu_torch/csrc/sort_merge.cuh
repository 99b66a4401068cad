// Shared core of K1 (tile_sort_merge.cu) and K2 (bin_sort_compress.cu): the
// per-row sort, duplicate merge and tail scan of the reference's Pallas
// kernels (benchmark_spgemm_using_csr_tpu/ops/pallas_kernels.py,
// _bitonic_stage and the Hillis–Steele loops of _sort_compress_kernel and
// _tile_sort_merge_kernel).
//
// One row of `width` lanes (a power of two) lives in shared memory as keys,
// values (V: float, or double for K2) and a scratch int per lane; width / 2
// threads own it, thread t the lanes a = t and b = t + width / 2. The
// function holds block-wide barriers: every thread of the block calls it,
// and every row of a block has the same width, so all threads pass the same
// barriers.
#pragma once

namespace sort_merge {

// What one lane knows after the merge: its sorted key, the segmented
// run-sum up to it, whether it is its run's tail (the last lane of a run of
// equal keys below the sentinel), and the inclusive count of tails up to it.
template <typename V>
struct Lane {
  int key;
  V run;
  int incl;
  bool tail;
};

template <typename V>
__device__ __forceinline__ void sort_merge_row(int* skey, V* sval, int* sflag,
                                               int width, int t, int sentinel,
                                               Lane<V>& la, Lane<V>& lb) {
  const int half = width >> 1;
  const int a = t;
  const int b = t + half;

  // 1. bitonic sort, ascending by (key, val). Thread t owns the pair
  //    (i, i + stride) where i is its t-th lane with the stride bit clear;
  //    bit `size` of i gives the direction of the merge.
  for (int size = 2; size <= width; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int i = 2 * t - (t & (stride - 1));
      const int j = i + stride;
      const int ki = skey[i];
      const int kj = skey[j];
      const V vi = sval[i];
      const V vj = sval[j];
      const bool greater = (ki > kj) || (ki == kj && vi > vj);
      const bool ascending = (i & size) == 0;
      if (greater == ascending) {
        skey[i] = kj;
        skey[j] = ki;
        sval[i] = vj;
        sval[j] = vi;
      }
      __syncthreads();
    }
  }

  // 2. run tails, then the run-sum and the inclusive tail-flag scan in one
  //    log-step loop (both read lane - k, so they share the barriers)
  const int ka = skey[a];
  const int kb = skey[b];
  const int kb_next = (b == width - 1) ? sentinel : skey[b + 1];
  const bool tail_a = ka < sentinel && ka != skey[a + 1];  // a < width - 1
  const bool tail_b = kb < sentinel && (kb != kb_next || b == width - 1);
  V run_a = sval[a];
  V run_b = sval[b];
  int incl_a = tail_a;
  int incl_b = tail_b;
  sflag[a] = incl_a;
  sflag[b] = incl_b;
  __syncthreads();
  for (int k = 1; k < width; k <<= 1) {
    V add_a = V(0), add_b = V(0);
    int fadd_a = 0, fadd_b = 0;
    if (a >= k) {
      if (skey[a - k] == ka) add_a = sval[a - k];
      fadd_a = sflag[a - k];
    }
    if (b >= k) {
      if (skey[b - k] == kb) add_b = sval[b - k];
      fadd_b = sflag[b - k];
    }
    __syncthreads();
    // always add (0 where the key differs), as the Pallas kernels do
    run_a = run_a + add_a;
    run_b = run_b + add_b;
    incl_a += fadd_a;
    incl_b += fadd_b;
    sval[a] = run_a;
    sval[b] = run_b;
    sflag[a] = incl_a;
    sflag[b] = incl_b;
    __syncthreads();
  }
  la = Lane<V>{ka, run_a, incl_a, tail_a};
  lb = Lane<V>{kb, run_b, incl_b, tail_b};
}

}  // namespace sort_merge
