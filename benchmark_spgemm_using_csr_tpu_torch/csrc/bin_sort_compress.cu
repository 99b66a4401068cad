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
// Steps 1-4 are sort_merge.cuh, shared with K1 (tile_sort_merge.cu): a row
// lives in registers, E = min(W, 8) lanes per thread, one instantiation per
// width 2..2048 and value type, chosen by the switch in launch().
//
// Design: 256 threads per block, 256 / (W / E) rows each (one row of 256
// threads at W = 2048). The callers' widths run from 8 to 512 (binned bins
// 8/32/128/512, tiled pad_bucket(max nnzCt) <= 512): up to W = 256 a row
// lies inside one warp and its sort and scans are register compare-exchanges
// and warp shuffles, with no block barrier. Rows past the end of the last
// block sort sentinel lanes and store nothing.
//
// What bounds it on the H100: device-memory traffic is 20 bytes per lane (8
// read, 12 written; 28 for float64) plus 4 per row, one coalesced pass with
// 16-byte vectors. The sort does W/2 * log2(W) * (log2(W) + 1) / 2
// compare-exchanges per row, each a compare and four selects (plus two
// shuffles per lane in the warp stages), and the run-sum log2(W) more steps
// per lane: at W = 32 (mc2depi's 524176 rows) the instructions take less
// time than the bytes, and the kernel ran at 80% of its HBM bound
// (PERF.md). Narrow bins with few rows (W = 8, 65536 rows) are bound by
// the launch and the load latency instead.

#include <cuda_runtime.h>

#include "sort_merge.cuh"

namespace {

using sort_merge::Geom;

template <typename V, int W>
__global__ void __launch_bounds__(sort_merge::kBlockThreads)
    bin_sort_compress_kernel(const int* __restrict__ col,
                             const V* __restrict__ val, int* __restrict__ ocol,
                             V* __restrict__ oval, int* __restrict__ pos,
                             int* __restrict__ cnt, long long rows,
                             int sentinel, bool vec) {
  constexpr int E = Geom<W>::E;
  constexpr int T = Geom<W>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r_local = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / T) + r_local;
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * W + t * E;

  sort_merge::Row<V, W> r;
  if (live) {
    sort_merge::load_lanes(r.key, col + base, vec);
    sort_merge::load_lanes(r.val, val + base, vec);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      r.key[e] = sentinel;
      r.val[e] = V(0);
    }
  }
  sort_merge::sort_merge_row<V, W>(
      r, t, sentinel, smem + r_local * sort_merge::scratch_bytes<V, W>());
  if (!live) return;

  int oc[E];
  V ov[E];
  int op[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    oc[e] = r.tail[e] ? r.key[e] : sentinel;
    ov[e] = r.tail[e] ? r.val[e] : V(0);
    op[e] = r.tail[e] ? r.incl[e] - 1 : W;
  }
  sort_merge::store_lanes(ocol + base, oc, vec);
  sort_merge::store_lanes(oval + base, ov, vec);
  sort_merge::store_lanes(pos + base, op, vec);
  // lane W - 1 holds the inclusive tail count of the whole row
  if (t == T - 1) cnt[row] = r.incl[E - 1];
}

struct Args {
  const void* col;
  const void* val;
  void* ocol;
  void* oval;
  void* pos;
  void* cnt;
  long long rows;
  int sentinel;
  cudaStream_t stream;
};

template <typename V, int W>
int launch_width(const Args& a) {
  constexpr int rows_per_block = sort_merge::kBlockThreads / Geom<W>::T;
  const long long blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = rows_per_block * sort_merge::scratch_bytes<V, W>();
  const auto kernel = bin_sort_compress_kernel<V, W>;
  if (smem > 48 * 1024) {  // above the default, ask for it
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto col = static_cast<const int*>(a.col);
  const auto val = static_cast<const V*>(a.val);
  const auto ocol = static_cast<int*>(a.ocol);
  const auto oval = static_cast<V*>(a.oval);
  const auto pos = static_cast<int*>(a.pos);
  const bool vec = sort_merge::aligned16(col, val, ocol, oval, pos);
  kernel<<<static_cast<unsigned>(blocks), sort_merge::kBlockThreads, smem,
           a.stream>>>(col, val, ocol, oval, pos, static_cast<int*>(a.cnt),
                       a.rows, a.sentinel, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch(const Args& a, int width) {
  switch (width) {
    case 2: return launch_width<V, 2>(a);
    case 4: return launch_width<V, 4>(a);
    case 8: return launch_width<V, 8>(a);
    case 16: return launch_width<V, 16>(a);
    case 32: return launch_width<V, 32>(a);
    case 64: return launch_width<V, 64>(a);
    case 128: return launch_width<V, 128>(a);
    case 256: return launch_width<V, 256>(a);
    case 512: return launch_width<V, 512>(a);
    case 1024: return launch_width<V, 1024>(a);
    case 2048: return launch_width<V, 2048>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer: col/ocol/pos (rows, width) int32, val/oval
// (rows, width) float32 (is_double 0) or float64 (is_double 1), cnt (rows,)
// int32, all contiguous. width is a power of two in 2..2048.
extern "C" int bin_sort_compress_launch(const void* col, const void* val,
                                        void* ocol, void* oval, void* pos,
                                        void* cnt, long long rows, int width,
                                        int sentinel, int is_double,
                                        void* stream) {
  if (width < 2 || width > 2048 || (width & (width - 1)) != 0 || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Args a{col, val, ocol, oval, pos, cnt, rows, sentinel,
               static_cast<cudaStream_t>(stream)};
  return is_double ? launch<double>(a, width) : launch<float>(a, width);
}
