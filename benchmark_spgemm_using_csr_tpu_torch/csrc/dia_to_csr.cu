// K4 — dia_to_csr for Hopper (sm_90a).
//
// Converts diagonal planes to CSR on the device: data is (nd, n), row-major,
// data[s][j] = M[j - off[s]][j] (scipy's convention), offsets sorted
// ascending; the output is rowptr (m + 1), colidx and vals (cap each, zero
// past nnz). A slot (s, r) lies in the matrix when 0 <= r + off[s] < n; with
// prune it is kept only when its value != 0 (so -0.0 goes, NaN stays, as
// torch's `data != 0`).
//
// No sort is needed: the offsets are sorted, so row r's slots visited in
// ascending s have ascending columns r + off[s], and each (row, column) lies
// on one plane, so nothing is summed. The values are copied: the output
// equals the plain PyTorch version (ops/dia_convert.dia_to_csr_plain) bit
// for bit.
//
// What bounds it on the H100: bytes. The least traffic reads each plane
// once, nd * n * sizeof(T), and writes rowptr, colidx and vals once,
// (m + 1) * 4 + cap * (4 + sizeof(T)) with the zero tail [nnz, cap). For
// poisson2d_724's C (13 planes of 524,176 float32) that is 27.3 MB read and
// 69.2 MB written, 29 us at 3.35 TB/s; without the tail, 84 MB and 25 us.
// On an H100 80GB HBM3 at 700 W the three kernels take 59 us there with
// the L2 flushed (49% of that bound): the count 19, the scan 2, the fill 38.
// Beyond the bound, the design below reads the planes a second time (27 MB,
// mostly from L2), writes and reads the per-thread counts (2 MB each) and
// waits for the scan between the count and the fill.
//
// Design. Three kernels on one stream, one call of the entry point, and
// nothing read back to the host (the host sizes cap from the offsets and
// the shape alone: the in-matrix slot count, an upper bound on nnz). A block
// of 256 threads takes R consecutive rows (256, 128, 64 or 32: the host's
// plan takes the most whose slots fit the staging window, so a block's
// output is staged in one pass up to 191 planes in float32, 127 in float64)
// and splits each row's planes among G = 256 / R threads, a chunk of
// consecutive planes each; lane i of a warp takes row i, so a warp's loads
// read 32 consecutive columns of one plane: coalesced.
//   1. count: each thread counts the kept slots of its chunk, writes the
//      count to its scratch word and the block's sum to sums[b].
//   2. scan: one block turns sums[] into exclusive block offsets in place
//      and writes nnz to sums[nblocks].
//   3. fill: a block scans its chunks' counts in row-major order (chunks of
//      a row in plane order), writes rowptr[r] = sums[b] + the row's
//      offset, walks each chunk again and stages each kept slot's column
//      and value in shared memory at its output position, then copies the
//      block's contiguous output range to colidx and vals. The staging
//      buffers are placed so that shared and global memory share their
//      16-byte alignment: the copy is 16-byte vectors, each lane a vector,
//      with scalars only at the range's two ends. A block whose output
//      outgrows the window (more planes than above) stages it in several
//      passes, a chunk taking part in those its range meets. Last, every
//      block zeroes its share of [nnz, cap) in 16-byte vectors.
// The planes are read twice (count and fill): the second read finds the
// block's rows in L1 or L2 (poisson2d_724's C planes, 27 MB, fit the 50 MB
// L2). The counts go through a scratch word a thread, so the fill does not
// recount. Offsets into the planes are 64-bit; positions are int32 (the host
// refuses more than 2^31 - 1 slots).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a block (dia_convert.THREADS)
constexpr int kScanThreads = 1024;
constexpr int kStaticSmem = 48 * 1024;  // above this, opt in per kernel
constexpr int kScanSmem = 32 * sizeof(int);  // block_scan's warp totals

// Inclusive scan of v over a block of kBlock threads; total gets the
// block's sum. Every thread must call it; it synchronises the block.
template <int kBlock>
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "");
  constexpr int kWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const int prefix = warp ? warp_tot[warp - 1] : 0;
  total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot may be reused
  return x + prefix;
}

// Whether slot value v is kept.
template <typename T, bool kPrune>
__device__ __forceinline__ bool kept(T v) {
  return !kPrune || v != T(0);
}

// Thread t of block b: row b * R + (t % R), planes [s0, s1) of its chunk
// t / R (R = 1 << rows_log2, G = kThreads / R chunks of ceil(nd / G)).
struct Slots {
  long long r;
  int s0, s1;
};

__device__ __forceinline__ Slots my_slots(int nd, int rows_log2) {
  const int t = threadIdx.x;
  const int g = t >> rows_log2;
  const int per = (nd + (kThreads >> rows_log2) - 1) / (kThreads >> rows_log2);
  const int s0 = min(nd, g * per);
  return Slots{(static_cast<long long>(blockIdx.x) << rows_log2) +
                   (t & ((1 << rows_log2) - 1)),
               s0, min(nd, s0 + per)};
}

template <typename T, bool kPrune>
__global__ void __launch_bounds__(kThreads)
    dia_to_csr_count(const T* __restrict__ data,
                     const int* __restrict__ offsets, int nd, long long m,
                     long long n, int rows_log2, int* __restrict__ counts,
                     int* __restrict__ sums) {
  __shared__ int warp_tot[kScanSmem / sizeof(int)];
  const Slots x = my_slots(nd, rows_log2);
  int c = 0;
  if (x.r < m) {
#pragma unroll 4
    for (int s = x.s0; s < x.s1; ++s) {
      const long long j = x.r + __ldg(offsets + s);
      if (j >= 0 && j < n && kept<T, kPrune>(data[s * n + j])) ++c;
    }
  }
  counts[static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x] = c;
  int total;
  block_scan<kThreads>(c, warp_tot, total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// sums[0, nb) -> exclusive offsets in place; sums[nb] = their total.
__global__ void __launch_bounds__(kScanThreads)
    dia_to_csr_scan(int* __restrict__ sums, int nb) {
  __shared__ int warp_tot[kScanSmem / sizeof(int)];
  int carry = 0;
  for (int base = 0; base < nb; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? sums[i] : 0;
    int total;
    const int incl = block_scan<kScanThreads>(v, warp_tot, total);
    if (i < nb) sums[i] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) sums[nb] = carry;
}

// dst[g0, g1) = the elements that src holds at g - a0, a0 = g0 rounded down
// to 16 bytes: whole 16-byte vectors, each lane one, and scalars at the ends.
template <typename U>
__device__ __forceinline__ void store_run(U* __restrict__ dst, const U* src,
                                          long long g0, long long g1) {
  constexpr long long E = 16 / sizeof(U);
  const long long a0 = g0 / E * E;
  const long long v0 = (g0 + E - 1) / E * E;  // first whole vector
  const long long t = threadIdx.x;
  if (v0 >= g1) {  // no whole vector
    if (t < g1 - g0) dst[g0 + t] = src[g0 - a0 + t];
    return;
  }
  const long long v1 = g1 / E * E;  // past the last whole vector
  if (t < v0 - g0) dst[g0 + t] = src[g0 - a0 + t];
  if (t < g1 - v1) dst[v1 + t] = src[v1 - a0 + t];
  for (long long g = v0 + t * E; g < v1; g += blockDim.x * E) {
    *reinterpret_cast<int4*>(dst + g) =
        *reinterpret_cast<const int4*>(src + (g - a0));
  }
}

// This block's share of dst[lo, hi) = 0, in 16-byte vectors (hi is a
// multiple of 16 bytes: cap is a power of two of at least 8).
template <typename U>
__device__ __forceinline__ void zero_tail(U* __restrict__ dst, long long lo,
                                          long long hi) {
  constexpr long long E = 16 / sizeof(U);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long v0 = min(hi, (lo + E - 1) / E * E);
  if (tid < v0 - lo) dst[lo + tid] = U(0);
  for (long long g = v0 + tid * E; g + E <= hi; g += stride * E) {
    *reinterpret_cast<int4*>(dst + g) = make_int4(0, 0, 0, 0);
  }
}

template <typename T, bool kPrune>
__global__ void __launch_bounds__(kThreads)
    dia_to_csr_fill(const T* __restrict__ data,
                    const int* __restrict__ offsets, int nd, long long m,
                    long long n, int rows_log2, int* __restrict__ rowptr,
                    int* __restrict__ colidx, T* __restrict__ vals,
                    const int* __restrict__ counts,
                    const int* __restrict__ sums, int nb, long long cap,
                    int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[kScanSmem / sizeof(int)];
  __shared__ int order[kThreads];  // chunk counts, then offsets, row-major
  // window + 4 slots each: a range starts up to 3 (1) slots past a0
  int* s_col = reinterpret_cast<int*>(smem);
  T* s_val = reinterpret_cast<T*>(smem + (window + 4) * sizeof(int));
  constexpr long long EC = 16 / sizeof(int);
  constexpr long long EV = 16 / sizeof(T);
  const Slots x = my_slots(nd, rows_log2);
  const int t = threadIdx.x;
  const int g = t >> rows_log2;
  const int u = ((t & ((1 << rows_log2) - 1)) << (8 - rows_log2)) + g;
  const long long base = sums[blockIdx.x];
  const long long nnz = sums[nb];
  const int c = counts[static_cast<long long>(blockIdx.x) * kThreads + t];
  order[u] = c;
  __syncthreads();
  const int v = order[t];
  int total;
  const int incl = block_scan<kThreads>(v, warp_tot, total);
  order[t] = incl - v;
  __syncthreads();
  const int start = order[u];
  if (g == 0 && x.r < m) rowptr[x.r] = static_cast<int>(base + start);
  if (blockIdx.x == nb - 1 && t == 0) rowptr[m] = static_cast<int>(nnz);
  for (int w = 0; w < total; w += window) {  // the same passes in each thread
    const int w1 = min(total, w + window);
    const long long g0 = base + w;
    const long long col0 = g0 / EC * EC;
    const long long val0 = g0 / EV * EV;
    if (x.r < m && start < w1 && start + c > w) {
      int k = start;
#pragma unroll 4
      for (int s = x.s0; s < x.s1; ++s) {
        const long long j = x.r + __ldg(offsets + s);
        if (j >= 0 && j < n) {
          const T val = data[s * n + j];
          if (kept<T, kPrune>(val)) {
            if (k >= w && k < w1) {
              s_col[base + k - col0] = static_cast<int>(j);
              s_val[base + k - val0] = val;
            }
            ++k;
          }
        }
      }
    }
    __syncthreads();
    store_run(colidx, s_col, g0, base + w1);
    store_run(vals, s_val, g0, base + w1);
    __syncthreads();
  }
  zero_tail(colidx, nnz, cap);
  zero_tail(vals, nnz, cap);
}

struct Args {
  const void* data;
  const int* offsets;
  int nd;
  long long m, n;
  int rows_log2;
  int* rowptr;
  int* colidx;
  void* vals;
  int* scratch;
  long long cap;
  int window;
  cudaStream_t stream;
};

template <typename T, bool kPrune>
int launch(const Args& x) {
  const long long rows = 1LL << x.rows_log2;
  const long long nb = x.m > 0 ? (x.m + rows - 1) / rows : 1;
  const size_t smem = (x.window + 4) * (sizeof(int) + sizeof(T));
  const T* data = static_cast<const T*>(x.data);
  T* vals = static_cast<T*>(x.vals);
  int* counts = x.scratch;
  int* sums = x.scratch + nb * kThreads;
  auto fill = dia_to_csr_fill<T, kPrune>;
  if (smem + kScanSmem + kThreads * sizeof(int) > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fill, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>(nb);
  dia_to_csr_count<T, kPrune><<<grid, kThreads, 0, x.stream>>>(
      data, x.offsets, x.nd, x.m, x.n, x.rows_log2, counts, sums);
  dia_to_csr_scan<<<1, kScanThreads, 0, x.stream>>>(sums,
                                                    static_cast<int>(nb));
  fill<<<grid, kThreads, smem, x.stream>>>(
      data, x.offsets, x.nd, x.m, x.n, x.rows_log2, x.rowptr, x.colidx, vals,
      counts, sums, static_cast<int>(nb), x.cap, x.window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer, all contiguous on one device: data (nd, n) of
// float (is_double == 0) or double, offsets (nd) int32 sorted ascending,
// rowptr (m + 1) int32, colidx (cap) int32 and vals (cap) of data's type,
// both 16-byte aligned, cap a power of two of at least 8 and at least the
// in-matrix slot count, and scratch (nb * 257 + 1) int32, nb = ceil(m /
// 2^rows_log2) blocks (at least 1) of 2^rows_log2 rows (32 to 256).
// window: output slots a fill block stages at once, a positive multiple of
// 4; the fill kernel takes (window + 4) * (4 + sizeof(T)) bytes of dynamic
// shared memory (at most 227 KB in all).
extern "C" int dia_to_csr_launch(const void* data, const void* offsets,
                                 int nd, long long m, long long n,
                                 int rows_log2, void* rowptr, void* colidx,
                                 void* vals, void* scratch, long long cap,
                                 int window, int prune, int is_double,
                                 void* stream) {
  if (nd < 0 || m < 0 || n < 0 || rows_log2 < 5 || rows_log2 > 8 ||
      cap < 8 || (cap & (cap - 1)) != 0 || window <= 0 || window % 4 != 0 ||
      reinterpret_cast<uintptr_t>(colidx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
      (m >> rows_log2) >= 0x7fffffffLL / kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args x{data, static_cast<const int*>(offsets), nd, m, n, rows_log2,
               static_cast<int*>(rowptr), static_cast<int*>(colidx), vals,
               static_cast<int*>(scratch), cap, window,
               static_cast<cudaStream_t>(stream)};
  if (is_double) {
    return prune ? launch<double, true>(x) : launch<double, false>(x);
  }
  return prune ? launch<float, true>(x) : launch<float, false>(x);
}
