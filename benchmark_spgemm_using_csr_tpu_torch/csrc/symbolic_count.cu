// K5 — symbolic_count for Hopper (sm_90a).
//
// The exact structural nnz of every row of C = A·B in CSR: counts[i] is the
// number of distinct columns among B's stored entries in the rows that A's
// stored entries of row i name. Values are never read, so a stored zero
// counts like any entry: the count is the key set the ESC numeric phases
// produce (ops/grouped, ops/tilepack), which keep every structural product.
//
// It replaces no TPU kernel. The reference package and the port's plans
// counted nnz(C) on the host with scipy's pattern product, which computes the
// whole of C's structure to read one integer; this kernel takes that product
// off the host (ops/symbolic.nnz_rows, the plans through
// ops/symbolic.exact_nnz_c). Its plain version is ops/symbolic.nnz_exact.
//
// What bounds it on the H100: bytes. Its least traffic reads A's colidx
// once, one B column a product and, a row, A's rowptr and the count
// written: 4·nnz_a + 4·products + 8·m bytes (A's rows and B's rowptr are
// the small part). At circuit_262k (1,339,646 entries, 40,220,155
// products, 262,144 rows) that is 168.3 MB, 50 us at 3.35 TB/s; at fem_81k
// (5,836,140 entries, 429,654,051 products) 1.74 GB, 520 us. A B row is
// read once per product that names it, so much of that traffic comes from
// L2.
//
// Design. Three kernels on one stream in one call of the entry point, and
// nothing read back to the host; the memory it holds is the (m) counts, a
// scratch of 2·m + 2 int32 and, only where n bits pass a block's shared
// memory, a global bitmap the caller caps (ops/symbolic: 256 MiB). Rows are
// binned on the device by their product count P (the sum of B's row lengths
// over the row's A entries):
//   1. rows: a warp a row computes P. A row of P <= 32 is counted there: the
//      warp expands its products into its lanes, one column a lane, and a
//      lane is a new column when it is the lowest lane holding that column
//      (__match_any_sync); the count is a ballot's popcount. Longer rows are
//      appended to one of two lists (integer atomics; their order does not
//      matter, each row's count is its own).
//   2. medium (32 < P <= 1024): a warp a listed row, with an open-addressing
//      hash of the next power of two >= 2·P slots (at most 2048, 8 KB) in
//      shared memory; a column that wins the slot's compare-and-swap is new.
//   3. long (P > 1024): a block a listed row, over a bitmap of n bits: in
//      shared memory while n/8 bytes fit beside the block's scan (n <= about
//      1.8M), else in a per-block slice of the global bitmap. A column whose
//      atomicOr turns its bit on is new. After the row the block clears what
//      it set: the whole bitmap where P passes its words, else by walking the
//      products again, so a row costs O(P) whatever n is.
// Both warps and blocks expand products by windows of A entries: the
// window's B row lengths are scanned, and each lane or thread takes the next
// product of the window and finds its entry by a binary search over the
// scan, so short B rows do not leave lanes idle. Kernels 2 and 3 walk their
// lists with a grid sized by the occupancy of the card, reading the list's
// length on the device. Counts are integers: the result is exact and the
// same on every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;  // kernel 1: 8 warps, a row each
constexpr int kSmall = 32;        // products a warp counts in its lanes
constexpr int kMedWarps = 4;      // kernel 2: 4 warps, a row each
constexpr int kHash = 2048;       // a warp's hash slots
constexpr int kMedium = kHash / 2;  // products of a medium row, at most
constexpr int kLong = 256;        // kernel 3: a block a row
constexpr int kEmpty = -1;
// kernel 3's dynamic shared memory besides the bitmap: the window's scan
// (int64) and B row starts (int32)
constexpr int kScanBytes = kLong * (8 + 4);

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// The products of row r: sum over its A entries of B's row lengths. Every
// lane of the warp calls it and gets the sum.
__device__ __forceinline__ long long row_products(
    const int* __restrict__ arp, const int* __restrict__ acol,
    const int* __restrict__ brp, int r, int lane) {
  long long p = 0;
  for (int e = arp[r] + lane; e < arp[r + 1]; e += 32) {
    const int c = acol[e];
    p += brp[c + 1] - brp[c];
  }
  return warp_sum(p);
}

// One window of up to 32 A entries of a row at `base`: each lane's entry's
// B row start and its inclusive scan of the lengths; returns the window's
// products. Every lane calls it.
__device__ __forceinline__ int warp_window(
    const int* __restrict__ acol, const int* __restrict__ brp, int base,
    int end, int lane, int& start, int& excl, int& incl) {
  const int e = base + lane;
  int len = 0;
  start = 0;
  if (e < end) {
    const int c = acol[e];
    start = brp[c];
    len = brp[c + 1] - start;
  }
  incl = warp_scan(len, lane);
  excl = incl - len;
  return __shfl_sync(kFull, incl, 31);
}

// The column of product q of a window (q < its products): the entry j is the
// first lane whose inclusive scan passes q. Every lane calls it.
__device__ __forceinline__ int warp_column(const int* __restrict__ bcol,
                                           int q, int start, int excl,
                                           int incl, bool live) {
  int j = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    if (__shfl_sync(kFull, incl, j + s - 1) <= q) j += s;
  }
  const int st = __shfl_sync(kFull, start, j);
  const int before = __shfl_sync(kFull, excl, j);
  return live ? bcol[st + q - before] : kEmpty;
}

// Kernel 1: P of every row; rows of P <= kSmall counted, the others listed.
__global__ void __launch_bounds__(kRowThreads) symbolic_count_rows(
    const int* __restrict__ arp, const int* __restrict__ acol,
    const int* __restrict__ brp, const int* __restrict__ bcol, int m,
    int* __restrict__ counts, int* __restrict__ heads,
    int* __restrict__ lists) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x) >> 5;
  if (row >= m) return;  // whole warps
  const int r = static_cast<int>(row);
  const long long p = row_products(arp, acol, brp, r, lane);
  if (p > kSmall) {
    if (lane == 0) {
      const int bin = p <= kMedium ? 0 : 1;
      lists[static_cast<long long>(bin) * m + atomicAdd(&heads[bin], 1)] = r;
    }
    return;
  }
  // lane k holds product k of the row (in A-entry, then B-row order)
  int key = kEmpty;
  int done = 0;
  const int end = arp[r + 1];
  for (int base = arp[r]; base < end; base += 32) {
    int start, excl, incl;
    const int total = warp_window(acol, brp, base, end, lane, start, excl,
                                  incl);
    const int col = warp_column(bcol, lane < total ? lane : 0, start, excl,
                                incl, lane < total);
    const int moved = __shfl_up_sync(kFull, col, done);
    if (lane >= done && lane < done + total) key = moved;
    done += total;
  }
  const unsigned peers = __match_any_sync(kFull, key);
  const bool head = key != kEmpty && __ffs(peers) - 1 == lane;
  const unsigned heads_mask = __ballot_sync(kFull, head);
  if (lane == 0) counts[r] = __popc(heads_mask);
}

// Kernel 2: the medium rows, a warp each, over a shared-memory hash.
__global__ void __launch_bounds__(kMedWarps * 32) symbolic_count_medium(
    const int* __restrict__ arp, const int* __restrict__ acol,
    const int* __restrict__ brp, const int* __restrict__ bcol,
    int* __restrict__ counts, const int* __restrict__ heads,
    const int* __restrict__ list) {
  __shared__ int s_hash[kMedWarps][kHash];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* table = s_hash[warp];
  const int rows = heads[0];
  for (int i = blockIdx.x * kMedWarps + warp; i < rows;
       i += gridDim.x * kMedWarps) {
    const int r = list[i];
    const int p = static_cast<int>(row_products(arp, acol, brp, r, lane));
    int bits = 5;
    while ((1 << bits) < 2 * p) ++bits;
    const int size = 1 << bits;
    for (int s = lane; s < size; s += 32) table[s] = kEmpty;
    __syncwarp();
    int fresh = 0;
    const int end = arp[r + 1];
    for (int base = arp[r]; base < end; base += 32) {
      int start, excl, incl;
      const int total = warp_window(acol, brp, base, end, lane, start, excl,
                                    incl);
      for (int q0 = 0; q0 < total; q0 += 32) {
        const int q = q0 + lane;
        const int col = warp_column(bcol, q < total ? q : 0, start, excl,
                                    incl, q < total);
        if (col == kEmpty) continue;
        unsigned s = (static_cast<unsigned>(col) * 2654435769u) >>
                     (32 - bits);
        while (true) {
          const int held = static_cast<volatile int*>(table)[s];
          if (held == col) break;
          if (held == kEmpty) {
            const int old = atomicCAS(&table[s], kEmpty, col);
            if (old == kEmpty) {
              ++fresh;
              break;
            }
            if (old == col) break;
          }
          s = (s + 1) & (size - 1);
        }
      }
    }
    const long long n_new = warp_sum(fresh);
    if (lane == 0) counts[r] = static_cast<int>(n_new);
    __syncwarp();
  }
}

// Inclusive scan of v over the block of kLong threads; synchronises it.
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += s_warp[w];
  __syncthreads();
  return v;
}

// Calls f(col) once for every product of row r, the block's threads taking
// consecutive products; returns the row's products. Every thread calls it.
template <typename F>
__device__ long long block_walk(const int* __restrict__ arp,
                                const int* __restrict__ acol,
                                const int* __restrict__ brp,
                                const int* __restrict__ bcol, int r,
                                long long* s_incl, int* s_start,
                                long long* s_warp, F f) {
  const int t = threadIdx.x;
  const int end = arp[r + 1];
  long long walked = 0;
  for (int base = arp[r]; base < end; base += kLong) {
    const int e = base + t;
    long long len = 0;
    int start = 0;
    if (e < end) {
      const int c = acol[e];
      start = brp[c];
      len = brp[c + 1] - start;
    }
    s_incl[t] = block_scan(len, s_warp);
    s_start[t] = start;
    __syncthreads();
    const long long total = s_incl[kLong - 1];
    for (long long q = t; q < total; q += kLong) {
      int j = 0;
#pragma unroll
      for (int s = kLong / 2; s > 0; s >>= 1) {
        if (s_incl[j + s - 1] <= q) j += s;
      }
      const long long before = j ? s_incl[j - 1] : 0;
      f(bcol[s_start[j] + (q - before)]);
    }
    walked += total;
    __syncthreads();
  }
  return walked;
}

// Kernel 3: the long rows, a block each, over a bitmap of n bits (in shared
// memory with kSharedMap, else the block's slice of `map`).
template <bool kSharedMap>
__global__ void __launch_bounds__(kLong) symbolic_count_long(
    const int* __restrict__ arp, const int* __restrict__ acol,
    const int* __restrict__ brp, const int* __restrict__ bcol,
    int* __restrict__ counts, const int* __restrict__ heads,
    const int* __restrict__ list, unsigned* __restrict__ map,
    long long words) {
  extern __shared__ long long s_dyn[];
  __shared__ long long s_warp[kLong / 32];
  __shared__ int s_count;
  const int rows = heads[1];
  if (static_cast<int>(blockIdx.x) >= rows) return;
  long long* s_incl = s_dyn;
  int* s_start = reinterpret_cast<int*>(s_incl + kLong);
  unsigned* bits = kSharedMap ? reinterpret_cast<unsigned*>(s_start + kLong)
                              : map + blockIdx.x * words;
  const int t = threadIdx.x;
  for (long long w = t; w < words; w += kLong) bits[w] = 0;
  if (t == 0) s_count = 0;
  __syncthreads();
  for (int i = blockIdx.x; i < rows; i += gridDim.x) {
    const int r = list[i];
    int fresh = 0;
    const long long p = block_walk(
        arp, acol, brp, bcol, r, s_incl, s_start, s_warp, [&](int col) {
          unsigned* w = bits + (col >> 5);
          const unsigned bit = 1u << (col & 31);
          if (!(*static_cast<volatile unsigned*>(w) & bit) &&
              !(atomicOr(w, bit) & bit)) {
            ++fresh;
          }
        });
    const long long n_new = warp_sum(fresh);
    if ((t & 31) == 0) atomicAdd(&s_count, static_cast<int>(n_new));
    if (p > words) {
      for (long long w = t; w < words; w += kLong) bits[w] = 0;
      __syncthreads();
    } else {
      block_walk(arp, acol, brp, bcol, r, s_incl, s_start, s_warp,
                 [&](int col) { bits[col >> 5] = 0; });
    }
    if (t == 0) {
      counts[r] = s_count;
      s_count = 0;
    }
    // the next row's first write to s_count or the bitmap follows a barrier
    // of its walk
  }
}

struct Args {
  const int* arp;
  const int* acol;
  const int* brp;
  const int* bcol;
  int m;
  long long words;
  int* counts;
  int* scratch;
  unsigned* map;
  long long map_words;
  cudaStream_t stream;
};

template <bool kSharedMap>
int launch_long(const Args& x, int sms, size_t smem) {
  const auto kernel = symbolic_count_long<kSharedMap>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kLong, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > x.m) grid = x.m;
  if (!kSharedMap) {
    const long long slices = x.map_words / x.words;
    if (slices < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (grid > slices) grid = slices;
  }
  kernel<<<static_cast<unsigned>(grid), kLong, smem, x.stream>>>(
      x.arp, x.acol, x.brp, x.bcol, x.counts, x.scratch,
      x.scratch + 2 + x.m, x.map, x.words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The caller
// allocates every buffer, contiguous int32 on one device: a_rowptr (m + 1),
// a_colidx, b_rowptr (A's n + 1), b_colidx, counts (m), scratch (2·m + 2;
// nothing in it is read before it is written) and, where ceil(n / 32) words
// and 4 KB do not fit the block's shared memory (the device's opt-in limit,
// 227 KB on an H100), map: map_words >= ceil(n / 32) words of uint32, a
// whole number of slices of that size (one per block of kernel 3, at most).
// Otherwise map may be null.
extern "C" int symbolic_count_launch(const void* a_rowptr,
                                     const void* a_colidx,
                                     const void* b_rowptr,
                                     const void* b_colidx, long long m,
                                     long long n, void* counts, void* scratch,
                                     void* map, long long map_words,
                                     void* stream) {
  if (m < 0 || m > 0x7ffffffeLL || n < 0 || n > 0x80000000LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const Args x{static_cast<const int*>(a_rowptr),
               static_cast<const int*>(a_colidx),
               static_cast<const int*>(b_rowptr),
               static_cast<const int*>(b_colidx),
               static_cast<int>(m),
               n > 0 ? (n + 31) / 32 : 1,
               static_cast<int*>(counts),
               static_cast<int*>(scratch),
               static_cast<unsigned*>(map),
               map_words,
               static_cast<cudaStream_t>(stream)};
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(x.scratch, 0, 2 * sizeof(int), x.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_blocks = (m * 32 + kRowThreads - 1) / kRowThreads;
  symbolic_count_rows<<<static_cast<unsigned>(row_blocks), kRowThreads, 0,
                        x.stream>>>(x.arp, x.acol, x.brp, x.bcol, x.m,
                                    x.counts, x.scratch, x.scratch + 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long med_blocks = (m + kMedWarps - 1) / kMedWarps;
  int med_per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &med_per_sm, symbolic_count_medium, kMedWarps * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long med_grid =
      static_cast<long long>(sms) * (med_per_sm > 0 ? med_per_sm : 1);
  if (med_blocks > med_grid) med_blocks = med_grid;
  symbolic_count_medium<<<static_cast<unsigned>(med_blocks), kMedWarps * 32,
                          0, x.stream>>>(x.arp, x.acol, x.brp, x.bcol,
                                         x.counts, x.scratch, x.scratch + 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t map_bytes = static_cast<size_t>(x.words) * sizeof(unsigned);
  // the static shared memory of kernel 3 (s_warp, s_count) lies within 1 KB
  if (map_bytes + kScanBytes + 1024 <= static_cast<size_t>(optin)) {
    return launch_long<true>(x, sms, kScanBytes + map_bytes);
  }
  if (x.map == nullptr || x.map_words < x.words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_long<false>(x, sms, kScanBytes);
}
