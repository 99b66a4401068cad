// K1 — tile_sort_merge for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmark_spgemm_using_csr_tpu/ops/pallas_kernels.py
// ::tile_sort_merge (Pallas kernel _tile_sort_merge_kernel). For each row of
// a (r, W) tile of packed product keys (local_row << cbits | col, invalid
// lanes = sentinel) and float32 values:
//   1. bitonic sort by (key, val), lexicographic;
//   2. segmented run-sum of equal keys with the same log-step (Hillis–Steele)
//      addition tree as the Pallas kernel, so sums agree bit for bit apart
//      from ties between -0.0 and +0.0;
//   3. run tails: okey = key, oval = run sum; other lanes sentinel / 0;
//   4. pos = the tail's index among the row's tails (inclusive scan of the
//      tail flags, minus one), W where the lane is dropped;
//   5. cnt[t, j] = tails whose (unsigned) key >> cbits == j, for j < wlr.
// Steps 1-4 are sort_merge.cuh, shared with K2 (bin_sort_compress.cu): a row
// lives in registers, 8 lanes per thread, one instantiation per width of the
// Pallas contract (128..2048), chosen by the switch in the launch function.
//
// Design: blocks of up to 256 threads hold several rows (16 at W = 128, 2 at
// W = 1024), fewer where the rows' wlr shared counters would pass 48 KB. A
// row of W <= 256 lies inside one warp: its sort and scans are register
// compare-exchanges and warp shuffles, its counters are guarded by
// __syncwarp, and it passes no block barrier. A row of W = 1024 spans four
// warps and passes 3 barriers for the sort stages that flip a lane bit
// >= 256, 10 for the run-sum and 1 for its counters (75 in the first,
// shared-memory form).
//
// What bounds it on the H100: device-memory traffic is 20 bytes per lane
// (8 read, 12 written) plus 4 per count, one coalesced pass with 16-byte
// vectors (81.5 us for er_medium's 13312 x 1024 tiles). The sort network is
// 55 stages of W/2 compare-exchanges at W = 1024, 25 of them with two warp
// shuffles per lane; every compare-exchange is a 64-bit compare and four
// selects, so the kernel is bound by instruction issue (compare, select,
// shuffle), not by HBM: it ran at 25% of the byte bound on er_medium's
// tiles (PERF.md).

#include <cuda_runtime.h>

#include "sort_merge.cuh"

namespace {

using sort_merge::Geom;

constexpr int kMaxWlr = 1024;
constexpr int kSmemBudget = 48 * 1024;  // bytes a block takes by default

template <int W>
__global__ void __launch_bounds__(sort_merge::kBlockThreads)
    tile_sort_merge_kernel(const int* __restrict__ key,
                           const float* __restrict__ val,
                           int* __restrict__ okey, float* __restrict__ oval,
                           int* __restrict__ pos, int* __restrict__ cnt,
                           int rows, int rows_per_block, int wlr, int cbits,
                           int sentinel, bool vec) {
  constexpr int E = Geom<W>::E;
  constexpr int T = Geom<W>::T;
  constexpr int kScratch = sort_merge::scratch_bytes<float, W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int r_local = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + r_local;
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * W + t * E;
  int* scnt = reinterpret_cast<int*>(smem + rows_per_block * kScratch) +
              r_local * wlr;
  for (int j = t; j < wlr; j += T) scnt[j] = 0;

  sort_merge::Row<float, W> r;
  if (live) {
    sort_merge::load_lanes(r.key, key + base, vec);
    sort_merge::load_lanes(r.val, val + base, vec);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      r.key[e] = sentinel;
      r.val[e] = 0.0f;
    }
  }
  sort_merge::sort_merge_row<float, W>(r, t, sentinel,
                                       smem + r_local * kScratch);

  // 5. per-local-row tail counts (logical shift, as the Pallas kernel). The
  //    zeroed counters are visible to the row after the core's barriers (a
  //    wide row) or this __syncwarp (a row inside one warp).
  if constexpr (!Geom<W>::kWide) __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned lr = static_cast<unsigned>(r.key[e]) >> cbits;
    if (r.tail[e] && lr < static_cast<unsigned>(wlr)) atomicAdd(&scnt[lr], 1);
  }
  if constexpr (Geom<W>::kWide) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  if (!live) return;

  int ok[E];
  float ov[E];
  int op[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ok[e] = r.tail[e] ? r.key[e] : sentinel;
    ov[e] = r.tail[e] ? r.val[e] : 0.0f;
    op[e] = r.tail[e] ? r.incl[e] - 1 : W;
  }
  sort_merge::store_lanes(okey + base, ok, vec);
  sort_merge::store_lanes(oval + base, ov, vec);
  sort_merge::store_lanes(pos + base, op, vec);
  const size_t cbase = static_cast<size_t>(row) * wlr;
  for (int j = t; j < wlr; j += T) cnt[cbase + j] = scnt[j];
}

struct Args {
  const int* key;
  const float* val;
  int* okey;
  float* oval;
  int* pos;
  int* cnt;
  int rows;
  int wlr;
  int cbits;
  int sentinel;
  cudaStream_t stream;
};

template <int W>
int launch_width(const Args& a) {
  constexpr int T = Geom<W>::T;
  // as many rows as 256 threads hold, fewer where the scratch and the wlr
  // counters would pass the budget; a power of two, and a whole warp at least
  const int row_bytes = sort_merge::scratch_bytes<float, W>() +
                        a.wlr * static_cast<int>(sizeof(int));
  int rows_per_block = sort_merge::kBlockThreads / T;
  while (rows_per_block * T > sort_merge::kWarp &&
         rows_per_block * row_bytes > kSmemBudget) {
    rows_per_block /= 2;
  }
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  const bool vec =
      sort_merge::aligned16(a.key, a.val, a.okey, a.oval, a.pos);
  tile_sort_merge_kernel<W><<<blocks, rows_per_block * T,
                              rows_per_block * row_bytes, a.stream>>>(
      a.key, a.val, a.okey, a.oval, a.pos, a.cnt, a.rows, rows_per_block,
      a.wlr, a.cbits, a.sentinel, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer: key/okey/pos (rows, width) int32, val/oval
// (rows, width) float32, cnt (rows, wlr) int32, all contiguous. width is a
// power of two in 128..2048, the Pallas kernel's contract.
extern "C" int tile_sort_merge_launch(const void* key, const void* val,
                                      void* okey, void* oval, void* pos,
                                      void* cnt, int rows, int width, int wlr,
                                      int cbits, int sentinel, void* stream) {
  if (width < 128 || width > 2048 || (width & (width - 1)) != 0 || wlr < 1 ||
      wlr > kMaxWlr || rows < 0 || cbits < 0 || cbits > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Args a{static_cast<const int*>(key), static_cast<const float*>(val),
               static_cast<int*>(okey),      static_cast<float*>(oval),
               static_cast<int*>(pos),       static_cast<int*>(cnt),
               rows, wlr, cbits, sentinel, static_cast<cudaStream_t>(stream)};
  switch (width) {
    case 128: return launch_width<128>(a);
    case 256: return launch_width<256>(a);
    case 512: return launch_width<512>(a);
    case 1024: return launch_width<1024>(a);
    case 2048: return launch_width<2048>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
