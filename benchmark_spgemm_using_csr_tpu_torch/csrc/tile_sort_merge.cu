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
// Steps 1-4 are sort_merge.cuh, shared with K2 (bin_sort_compress.cu).
//
// Design: one thread block per tile row, W/2 threads; the row's keys,
// values and tail flags live in shared memory (12 bytes per lane: 24 KB at
// W = 2048), the counts in wlr shared ints updated with atomicAdd.
//
// What bounds it on the H100: device-memory traffic is 20 bytes per lane
// (8 read, 12 written), one coalesced pass, while the sort costs
// log2(W) * (log2(W) + 1) / 2 __syncthreads stages of shared-memory
// compare-exchange (55 at W = 1024) plus 2 * log2(W) more for the run-sum
// and scan: the kernel is bound by shared-memory latency and block-wide
// barriers, not by HBM. Warp-shuffle stages for strides < 32, several rows
// per block, TMA and wgmma are left for later work.

#include <cuda_runtime.h>

#include "sort_merge.cuh"

namespace {

constexpr int kMaxWidth = 2048;  // W / 2 <= 1024 threads
constexpr int kMaxWlr = 1024;

__global__ void __launch_bounds__(1024) tile_sort_merge_kernel(
    const int* __restrict__ key, const float* __restrict__ val,
    int* __restrict__ okey, float* __restrict__ oval, int* __restrict__ pos,
    int* __restrict__ cnt, int width, int wlr, int cbits, int sentinel) {
  extern __shared__ int smem[];
  int* skey = smem;                                          // width
  float* sval = reinterpret_cast<float*>(smem + width);      // width
  int* sflag = smem + 2 * width;                             // width
  int* scnt = smem + 3 * width;                              // wlr

  const int half = width >> 1;
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * width;

  // this thread's two lanes: a and b = a + half (coalesced loads/stores)
  const int a = t;
  const int b = t + half;
  skey[a] = key[base + a];
  skey[b] = key[base + b];
  sval[a] = val[base + a];
  sval[b] = val[base + b];
  for (int j = t; j < wlr; j += half) scnt[j] = 0;
  __syncthreads();

  sort_merge::Lane<float> la, lb;
  sort_merge::sort_merge_row(skey, sval, sflag, width, t, sentinel, la, lb);

  okey[base + a] = la.tail ? la.key : sentinel;
  okey[base + b] = lb.tail ? lb.key : sentinel;
  oval[base + a] = la.tail ? la.run : 0.0f;
  oval[base + b] = lb.tail ? lb.run : 0.0f;
  pos[base + a] = la.tail ? la.incl - 1 : width;
  pos[base + b] = lb.tail ? lb.incl - 1 : width;

  // 5. per-local-row tail counts (logical shift, as the Pallas kernel)
  if (la.tail) {
    const unsigned lr = static_cast<unsigned>(la.key) >> cbits;
    if (lr < static_cast<unsigned>(wlr)) atomicAdd(&scnt[lr], 1);
  }
  if (lb.tail) {
    const unsigned lr = static_cast<unsigned>(lb.key) >> cbits;
    if (lr < static_cast<unsigned>(wlr)) atomicAdd(&scnt[lr], 1);
  }
  __syncthreads();
  const size_t cbase = static_cast<size_t>(blockIdx.x) * wlr;
  for (int j = t; j < wlr; j += half) cnt[cbase + j] = scnt[j];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer: key/okey/pos (rows, width) int32, val/oval
// (rows, width) float32, cnt (rows, wlr) int32, all contiguous.
extern "C" int tile_sort_merge_launch(const void* key, const void* val,
                                      void* okey, void* oval, void* pos,
                                      void* cnt, int rows, int width, int wlr,
                                      int cbits, int sentinel, void* stream) {
  if (width < 2 || width > kMaxWidth || (width & (width - 1)) != 0 ||
      wlr < 1 || wlr > kMaxWlr || rows < 0 || cbits < 0 || cbits > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const size_t smem = (3 * static_cast<size_t>(width) + wlr) * sizeof(int);
  tile_sort_merge_kernel<<<rows, width / 2, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(key), static_cast<const float*>(val),
      static_cast<int*>(okey), static_cast<float*>(oval),
      static_cast<int*>(pos), static_cast<int*>(cnt), width, wlr, cbits,
      sentinel);
  return static_cast<int>(cudaGetLastError());
}
