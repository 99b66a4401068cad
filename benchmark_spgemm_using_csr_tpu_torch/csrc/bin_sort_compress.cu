// K2 — bin_sort_compress for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmark_spgemm_using_csr_tpu/ops/pallas_kernels.py
// ::bin_sort_compress (Pallas kernel _sort_compress_kernel). For each row of
// a (rows, W) tile of gathered products (column ids, invalid lanes hold the
// sentinel column n) and float32 or float64 values (the kernel is a
// template on the value type, as the Pallas kernel takes any value type):
//   1. bitonic sort by (col, val), lexicographic;
//   2. segmented run-sum of equal columns with the Pallas kernel's log-step
//      (Hillis–Steele) addition tree, always adding, so -0.0 turns +0.0;
//   3. run tails: ocol = col, oval = run sum; other lanes n / 0;
//   4. pos = the tail's index among the row's tails, W where dropped;
//   5. cnt[row] = the row's number of tails, its exact nnz(C).
// Steps 1-4 are sort_merge.cuh, shared with K1 (tile_sort_merge.cu).
//
// Design: W / 2 threads own a row, as in K1, but the callers' widths run
// down to 8 (binned bins 8/32/128/512, tiled pad_bucket(max nnzCt) <= 512),
// where one row per block would leave most of each warp idle. A block
// therefore holds max(1, 256 / (W / 2)) rows, 256 threads (W / 2 above
// W = 512); all rows of a block share the width, so they pass the same
// barriers. Rows past the end of the last block sort sentinel lanes and
// store nothing.
//
// What bounds it on the H100: device-memory traffic is 20 bytes per lane (8
// read, 12 written; 28 for float64) plus 4 per row, one coalesced pass; the sort costs
// log2(W) * (log2(W) + 1) / 2 block-wide barrier stages of shared-memory
// compare-exchange plus 2 * log2(W) for the run-sum and scan. At W = 32
// (mc2depi's tiled tile) that is 15 + 10 barriers per 16-lane row group,
// so the kernel sits between shared-memory latency and HBM; warp-shuffle
// stages for W <= 64 are left for later work.

#include <cuda_runtime.h>

#include "sort_merge.cuh"

namespace {

constexpr int kMaxWidth = 2048;  // W / 2 <= 1024 threads
constexpr int kBlockThreads = 256;

template <typename V>
__global__ void __launch_bounds__(1024) bin_sort_compress_kernel(
    const int* __restrict__ col, const V* __restrict__ val,
    int* __restrict__ ocol, V* __restrict__ oval, int* __restrict__ pos,
    int* __restrict__ cnt, long long rows, int width, int rows_per_block,
    int sentinel) {
  // per row: width keys, width values, width flags; width is even, so
  // every array starts at a multiple of 8 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = width >> 1;
  const int r_local = threadIdx.x / half;
  const int t = threadIdx.x - r_local * half;
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + r_local;
  const bool live = row < rows;
  const size_t row_bytes = static_cast<size_t>(width) *
                           (2 * sizeof(int) + sizeof(V));
  int* skey = reinterpret_cast<int*>(smem + r_local * row_bytes);
  V* sval = reinterpret_cast<V*>(skey + width);
  int* sflag = reinterpret_cast<int*>(sval + width);

  // this thread's two lanes: a and b = a + half (coalesced loads/stores)
  const int a = t;
  const int b = t + half;
  const size_t base = static_cast<size_t>(live ? row : 0) * width;
  skey[a] = live ? col[base + a] : sentinel;
  skey[b] = live ? col[base + b] : sentinel;
  sval[a] = live ? val[base + a] : V(0);
  sval[b] = live ? val[base + b] : V(0);
  __syncthreads();

  sort_merge::Lane<V> la, lb;
  sort_merge::sort_merge_row(skey, sval, sflag, width, t, sentinel, la, lb);
  if (!live) return;

  ocol[base + a] = la.tail ? la.key : sentinel;
  ocol[base + b] = lb.tail ? lb.key : sentinel;
  oval[base + a] = la.tail ? la.run : V(0);
  oval[base + b] = lb.tail ? lb.run : V(0);
  pos[base + a] = la.tail ? la.incl - 1 : width;
  pos[base + b] = lb.tail ? lb.incl - 1 : width;
  // lane W - 1 holds the inclusive tail count of the whole row
  if (b == width - 1) cnt[row] = lb.incl;
}

template <typename V>
int launch(const void* col, const void* val, void* ocol, void* oval,
           void* pos, void* cnt, long long rows, int width, int sentinel,
           cudaStream_t stream) {
  const int half = width / 2;
  const int rows_per_block = half >= kBlockThreads ? 1 : kBlockThreads / half;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows_per_block) * width *
                      (2 * sizeof(int) + sizeof(V));
  bin_sort_compress_kernel<V><<<static_cast<unsigned>(blocks),
                                rows_per_block * half, smem, stream>>>(
      static_cast<const int*>(col), static_cast<const V*>(val),
      static_cast<int*>(ocol), static_cast<V*>(oval), static_cast<int*>(pos),
      static_cast<int*>(cnt), rows, width, rows_per_block, sentinel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer: col/ocol/pos (rows, width) int32, val/oval
// (rows, width) float32 (is_double 0) or float64 (is_double 1), cnt (rows,)
// int32, all contiguous.
extern "C" int bin_sort_compress_launch(const void* col, const void* val,
                                        void* ocol, void* oval, void* pos,
                                        void* cnt, long long rows, int width,
                                        int sentinel, int is_double,
                                        void* stream) {
  if (width < 2 || width > kMaxWidth || (width & (width - 1)) != 0 ||
      rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(col, val, ocol, oval, pos, cnt, rows,
                                    width, sentinel, s)
                   : launch<float>(col, val, ocol, oval, pos, cnt, rows,
                                   width, sentinel, s);
}
