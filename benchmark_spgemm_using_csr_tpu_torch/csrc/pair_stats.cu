// K7 — pair_stats for Hopper (sm_90a).
//
// The structure-only statistics the dispatcher prices C = A·B from
// (ops/dispatch: the seven estimate_*_s), for A of m x k and B of k x n in
// CSR, into one small int64 vector that the host reads back once
// (ops/pair_stats.py names its fields):
//   - A's and B's nnz, the products sum_e |B[A.colidx[e], :]|, the rows of A
//     with entries, the A entries whose B row is empty;
//   - for grouped, over A's entries sum ceil(len / c) and over B's rows
//     sum ceil(len_B / c), c in {2, 4, 8};
//   - for tilepack (chunks of 8): each row's chunk count with and without a
//     chunk for an empty B row, their maxima, and where its gates pass the
//     greedy fill's tile count and the most rows one tile packs;
//   - for dia: the distinct diagonals of A and of B, and their offsets,
//     sorted, where a matrix has at most 4096;
//   - for bsr, where the shapes divide: the pairs of A's (8, 128) blocks with
//     B's (128, 128) blocks, sum over A's distinct blocks (I, K) of B's
//     distinct blocks in block row K.
// Values are never read. Every count is an integer, so the result is exact
// and the same on every run; the host computes the estimates' floats from it
// as it did from numpy's passes.
//
// It replaces no TPU kernel. The reference package prices the methods on the
// host with numpy (its ops/dispatch.py), as the port did: a copy of both
// structures to the host, a gather and ceil-division passes, a sort of every
// entry's block key and of every entry's diagonal, and the tilepack plan's
// Python greedy fill over all rows, on every structure the dispatcher sees.
//
// What bounds it on the H100: bytes. Its least traffic reads A's rowptr and
// colidx and B's rowptr and colidx once each: 4·(m + 1 + nnz_a) +
// 4·(k + 1 + nnz_b) bytes, ~33 MB at webbase_1m (3.1M entries a side, 1M
// rows), 10 us at 3.35 TB/s. B's row lengths, gathered once an A entry, come
// from L2 (B's rowptr is 4 MB there, against 50 MB of L2); the bsr pass
// reads the structures once more. The design keeps every pass a single read:
//   1. rows of A, a warp a row: lanes stride the row's entries, gather B's
//      row lengths, set the entry's diagonal bit, and the warp's sums give
//      the row's chunk counts (kept for the fill) and the block's partial
//      sums and maxima (one atomic a block and a field);
//   2. rows of B, a warp a row: the ceil sums of B's row lengths and B's
//      diagonal bits;
//   3. the two diagonal bitmaps' popcounts; 4. where a matrix has at most
//      4096 diagonals, one block lists its set bits in order;
//   5. the greedy fill, only where tilepack's gates pass (read on the
//      device): a row never straddles a tile, so the fill is sequential in
//      the rows. Its state is small (the chunks used in the open tile, at
//      most 256), so each block takes a segment of 4096 rows, stages their
//      chunk counts in shared memory, and a thread per possible entry state
//      runs the segment from that state (end state, tiles opened, rows in
//      the first, middle and last tiles); one thread then chains the
//      segments from state 0, one read a segment;
//   6. bsr: a block a block row, over a bitmap of block columns (in shared
//      memory, or a slice of device memory where it does not fit): B's pass
//      counts each block row's distinct blocks, A's adds B's count of every
//      distinct block it finds.
// Bits are set by a read first and an atomicOr only where the bit is off, so
// a stencil's few diagonals cost reads from L2, not contended atomics.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListThreads = 1024;

// the vector's fields, in ops/pair_stats.FIELDS order, then the offsets
enum Field {
  kNnzA, kNnzB, kProducts, kRowsNe, kZero, kSlots2, kSlots4, kSlots8,
  kPad2, kPad4, kPad8, kMaxChunks, kMaxChunksSet, kTiles, kMaxRows,
  kDiagsA, kDiagsB, kBsrPairs, kFields
};
constexpr int kMaxDiags = 4096;  // offsets listed up to this many diagonals
constexpr int kAl = 8;           // tilepack's chunk quantum
constexpr int kMaxW = 2048;      // tilepack's widest tile, lanes
constexpr int kStates = kMaxW / kAl + 1;  // chunks the open tile holds
constexpr int kSeg = 4096;       // rows a fill segment
constexpr int kSegOut = 5;       // a segment's result for one entry state
constexpr long long kMaxProducts = 1LL << 27;
constexpr int kBsrBm = 8;        // A's block rows; A's and B's block columns
constexpr int kBsrShift = 7;     // are 128 wide, B's block rows 128 tall
constexpr int kBsrBk = 1 << kBsrShift;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The block's sum of v; every thread calls it and gets the sum. `s_warp`
// holds kWarps partials; the caller's next write to it follows a barrier.
__device__ __forceinline__ long long block_sum(long long v,
                                               long long* s_warp) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ void set_bit(unsigned* map, long long bit) {
  unsigned* w = map + (bit >> 5);
  const unsigned b = 1u << (bit & 31);
  if (!(__ldcg(w) & b)) atomicOr(w, b);
}

// Kernel 1: A's rows. Sums kProducts, kZero, kSlots{2,4,8}, kRowsNe and the
// maxima kMaxChunks (chunks of 8) and kMaxChunksSet (an empty B row's entry
// taking one chunk); per row its chunks and empty-B-row entries.
constexpr int kRowFields = 8;
__constant__ int kRowField[kRowFields] = {kProducts, kZero,    kSlots2,
                                          kSlots4,   kSlots8,  kRowsNe,
                                          kMaxChunks, kMaxChunksSet};
__global__ void __launch_bounds__(kThreads) rows_a(
    const int* __restrict__ arp, const int* __restrict__ acol,
    const int* __restrict__ brp, long long m,
    int* __restrict__ row_chunks, int* __restrict__ row_zero,
    unsigned* __restrict__ diag, long long* __restrict__ out) {
  __shared__ long long s_part[kWarps][kRowFields];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long acc[kRowFields] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (long long i = static_cast<long long>(blockIdx.x) * kWarps + warp;
       i < m; i += static_cast<long long>(gridDim.x) * kWarps) {
    const int rs = arp[i], re = arp[i + 1];
    long long p = 0, z = 0, c2 = 0, c4 = 0, c8 = 0;
    for (int e = rs + lane; e < re; e += 32) {
      const int col = acol[e];
      const long long len = brp[col + 1] - brp[col];
      p += len;
      z += len == 0;
      c2 += (len + 1) >> 1;
      c4 += (len + 3) >> 2;
      c8 += (len + 7) >> 3;
      set_bit(diag, col - i + (m - 1));
    }
    p = warp_sum(p);
    z = warp_sum(z);
    c2 = warp_sum(c2);
    c4 = warp_sum(c4);
    c8 = warp_sum(c8);
    if (lane == 0) {
      acc[0] += p;
      acc[1] += z;
      acc[2] += c2;
      acc[3] += c4;
      acc[4] += c8;
      acc[5] += re > rs;
      acc[6] = c8 > acc[6] ? c8 : acc[6];
      acc[7] = c8 + z > acc[7] ? c8 + z : acc[7];
      row_chunks[i] = static_cast<int>(c8 < INT_MAX ? c8 : INT_MAX);
      row_zero[i] = static_cast<int>(z < INT_MAX ? z : INT_MAX);
    }
  }
  if (lane == 0) {
    for (int f = 0; f < kRowFields; ++f) s_part[warp][f] = acc[f];
  }
  __syncthreads();
  if (threadIdx.x < kRowFields) {
    const int f = threadIdx.x;
    long long v = 0;
    for (int w = 0; w < kWarps; ++w) {
      const long long x = s_part[w][f];
      v = f < 6 ? v + x : (x > v ? x : v);
    }
    unsigned long long* dst =
        reinterpret_cast<unsigned long long*>(out + kRowField[f]);
    if (f < 6) {
      if (v) atomicAdd(dst, static_cast<unsigned long long>(v));
    } else {
      atomicMax(reinterpret_cast<long long*>(dst), v);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[kNnzA] = arp[m];
}

// Kernel 2: B's rows. Sums kPad{2,4,8}; B's diagonal bits.
__global__ void __launch_bounds__(kThreads) rows_b(
    const int* __restrict__ brp, const int* __restrict__ bcol, long long k,
    long long n, unsigned* __restrict__ diag, long long* __restrict__ out) {
  __shared__ long long s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long p2 = 0, p4 = 0, p8 = 0;
  for (long long j = static_cast<long long>(blockIdx.x) * kWarps + warp;
       j < k; j += static_cast<long long>(gridDim.x) * kWarps) {
    const int rs = brp[j], re = brp[j + 1];
    for (int e = rs + lane; e < re; e += 32) {
      set_bit(diag, bcol[e] - j + (k - 1));
    }
    if (lane == 0) {
      const long long len = re - rs;
      p2 += (len + 1) >> 1;
      p4 += (len + 3) >> 2;
      p8 += (len + 7) >> 3;
    }
  }
  const long long sums[3] = {block_sum(p2, s_warp), block_sum(p4, s_warp),
                             block_sum(p8, s_warp)};
  if (threadIdx.x < 3 && sums[threadIdx.x]) {
    atomicAdd(reinterpret_cast<unsigned long long*>(out + kPad2 +
                                                    threadIdx.x),
              static_cast<unsigned long long>(sums[threadIdx.x]));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[kNnzB] = brp[k];
}

// Kernel 3: the set bits of A's bitmap (words [0, words_a)) and of B's.
__global__ void __launch_bounds__(kThreads) count_bits(
    const unsigned* __restrict__ diag, long long words_a, long long words,
    long long* __restrict__ out) {
  __shared__ long long s_warp[kWarps];
  long long ca = 0, cb = 0;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < words; w += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = __popc(diag[w]);
    if (w < words_a) {
      ca += c;
    } else {
      cb += c;
    }
  }
  ca = block_sum(ca, s_warp);
  cb = block_sum(cb, s_warp);
  if (threadIdx.x == 0 && ca) {
    atomicAdd(reinterpret_cast<unsigned long long*>(out + kDiagsA),
              static_cast<unsigned long long>(ca));
  }
  if (threadIdx.x == 1 && cb) {
    atomicAdd(reinterpret_cast<unsigned long long*>(out + kDiagsB),
              static_cast<unsigned long long>(cb));
  }
}

// Kernel 4: block 0 lists A's diagonals, block 1 B's, in order, as
// offsets col - row, where the matrix has at most kMaxDiags.
__global__ void __launch_bounds__(kListThreads) list_offsets(
    const unsigned* __restrict__ diag, long long words_a, long long words_b,
    long long rows_a, long long rows_b, long long* __restrict__ out) {
  __shared__ int s_warp[kListThreads / 32];
  const bool is_b = blockIdx.x == 1;
  if (out[is_b ? kDiagsB : kDiagsA] > kMaxDiags) return;
  const unsigned* map = diag + (is_b ? words_a : 0);
  const long long words = is_b ? words_b : words_a;
  const long long shift = (is_b ? rows_b : rows_a) - 1;
  long long* dst = out + kFields + (is_b ? kMaxDiags : 0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long per = (words + kListThreads - 1) / kListThreads;
  const long long lo = t * per;
  const long long hi = lo + per < words ? lo + per : words;
  int count = 0;
  for (long long w = lo; w < hi; ++w) count += __popc(map[w]);
  // the block's exclusive scan of the counts
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = incl - count;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  for (long long w = lo; w < hi; ++w) {
    for (unsigned bits = map[w]; bits; bits &= bits - 1) {
      dst[base++] = w * 32 + (__ffs(bits) - 1) - shift;
    }
  }
}

// tilepack's gates before its fill, mirroring ops/tilepack.tile_width,
// read from kernel 1's sums: the chunks of the open tile and whether an
// empty B row's entry takes a chunk. False where the plan refuses.
__device__ bool fill_gate(const long long* out, long long m, long long n,
                          int* wlr, bool* set) {
  const long long products = out[kProducts];
  if (m <= 0 || n <= 0 || products <= 0 || products > kMaxProducts) {
    return false;
  }
  const long long lim = out[kNnzA] / 16;
  *set = out[kZero] <= (lim > 64 ? lim : 64);
  long long mc = *set ? out[kMaxChunksSet] : out[kMaxChunks];
  mc = mc > 1 ? mc : 1;
  long long w = 128;
  while (w < kAl * mc) w <<= 1;
  if (w > kMaxW) return false;
  *wlr = static_cast<int>(w / kAl);
  return true;
}

// Kernel 5: a segment of kSeg rows run from every state of the open tile:
// its end state, the tiles it opens, the rows it adds to the tile it
// entered, the rows of its last tile and the most rows of a tile it opens
// and closes.
__global__ void __launch_bounds__(kThreads) fill_segments(
    const int* __restrict__ row_chunks, const int* __restrict__ row_zero,
    long long m, long long n, const long long* __restrict__ out,
    int* __restrict__ seg) {
  __shared__ int s_c[kSeg];
  int wlr;
  bool set;
  if (!fill_gate(out, m, n, &wlr, &set)) return;
  const long long r0 = static_cast<long long>(blockIdx.x) * kSeg;
  const int len = static_cast<int>(m - r0 < kSeg ? m - r0 : kSeg);
  for (int r = threadIdx.x; r < len; r += kThreads) {
    s_c[r] = row_chunks[r0 + r] + (set ? row_zero[r0 + r] : 0);
  }
  __syncthreads();
  for (int s = threadIdx.x; s <= wlr; s += kThreads) {
    int cur = s, opened = 0, head = 0, rows = 0, most = 0;
    for (int r = 0; r < len; ++r) {
      const int c = s_c[r];
      if (c == 0) continue;
      if (cur + c > wlr) {
        if (opened == 0) {
          head = rows;
        } else if (rows > most) {
          most = rows;
        }
        ++opened;
        cur = 0;
        rows = 0;
      }
      cur += c;
      ++rows;
    }
    if (opened == 0) head = rows;
    int* dst = seg + (static_cast<long long>(blockIdx.x) * kStates + s) *
                         kSegOut;
    dst[0] = cur;
    dst[1] = opened;
    dst[2] = head;
    dst[3] = rows;
    dst[4] = most;
  }
}

// Kernel 6 (one thread): the segments chained from state 0.
__global__ void fill_combine(const int* __restrict__ seg, long long m,
                             long long n, long long* __restrict__ out) {
  int wlr;
  bool set;
  if (!fill_gate(out, m, n, &wlr, &set)) return;
  const long long segs = (m + kSeg - 1) / kSeg;
  int state = 0;
  long long tiles = 1, rows = 0, most = 1;
  for (long long g = 0; g < segs; ++g) {
    const int* f = seg + (g * kStates + state) * kSegOut;
    const int opened = f[1], head = f[2];
    if (opened == 0) {
      rows += head;
    } else {
      const long long first = rows + head;
      most = first > most ? first : most;
      most = f[4] > most ? f[4] : most;
      rows = f[3];
      tiles += opened;
    }
    state = f[0];
  }
  out[kTiles] = tiles;
  out[kMaxRows] = rows > most ? rows : most;
}

// Kernel 7: bsr's blocks, a block a block row of `bm` rows, over a bitmap of
// the block columns (`words` words: in shared memory, or with `gmap` the
// block's slice of it, zeroed by the caller). Without `weights` it writes
// each block row's distinct blocks to `counts`; with them it adds the
// weight of every distinct block column to `pairs`.
__global__ void __launch_bounds__(kThreads) bsr_blocks(
    const int* __restrict__ rowptr, const int* __restrict__ colidx,
    long long block_rows, int bm, long long words, unsigned* gmap,
    const int* __restrict__ weights, int* __restrict__ counts,
    long long* __restrict__ pairs) {
  extern __shared__ unsigned s_map[];
  __shared__ long long s_warp[kWarps];
  unsigned* map = gmap ? gmap + blockIdx.x * words : s_map;
  const int t = threadIdx.x;
  if (!gmap) {
    for (long long w = t; w < words; w += kThreads) map[w] = 0;
  }
  __syncthreads();
  long long acc = 0;
  for (long long g = blockIdx.x; g < block_rows; g += gridDim.x) {
    const int lo = rowptr[g * bm], hi = rowptr[(g + 1) * bm];
    long long fresh = 0;
    for (int e = lo + t; e < hi; e += kThreads) {
      const int bc = colidx[e] >> kBsrShift;
      const unsigned bit = 1u << (bc & 31);
      if (!(atomicOr(map + (bc >> 5), bit) & bit)) {
        fresh += weights ? weights[bc] : 1;
      }
    }
    fresh = block_sum(fresh, s_warp);  // its barriers end the bits' writes
    if (t == 0) {
      if (counts) counts[g] = static_cast<int>(fresh);
      acc += fresh;
    }
    for (int e = lo + t; e < hi; e += kThreads) {
      map[colidx[e] >> (kBsrShift + 5)] = 0;
    }
    __syncthreads();
  }
  if (pairs && t == 0 && acc) {
    atomicAdd(reinterpret_cast<unsigned long long*>(pairs),
              static_cast<unsigned long long>(acc));
  }
}

unsigned grid_for(long long items, long long cap) {
  return static_cast<unsigned>(items < cap ? (items > 0 ? items : 1) : cap);
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The caller
// allocates every buffer on one device: a_rowptr (m + 1), a_colidx,
// b_rowptr (k + 1), b_colidx: contiguous int32; out: kFields + 2·4096 int64
// (zeroed here; ops/pair_stats.FIELDS, then A's and B's offsets); rows: 2·m
// int32; diag: ceil((m + k - 1) / 32) + ceil((k + n - 1) / 32) uint32
// (zeroed here); seg: ceil(m / 4096)·257·5 int32. bsr nonzero (m % 8,
// k % 128 and n % 128 all 0) counts bsr's pairs: bsr_blen takes k / 128
// int32; bsr_slices 0 keeps the bitmaps of ceil(k / 4096) and
// ceil(n / 4096) words in shared memory (both at most 48 KB), else bsr_map
// holds bsr_slices slices of the larger (zeroed here).
extern "C" int pair_stats_launch(
    const void* a_rowptr, const void* a_colidx, const void* b_rowptr,
    const void* b_colidx, long long m, long long k, long long n, void* out,
    void* rows, void* diag, void* seg, int bsr, void* bsr_blen,
    void* bsr_map, long long bsr_slices, void* stream) {
  if (m < 0 || k < 0 || n < 0 || m > 0x7ffffffeLL || k > 0x7ffffffeLL ||
      n > 0x80000000LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* arp = static_cast<const int*>(a_rowptr);
  const int* acol = static_cast<const int*>(a_colidx);
  const int* brp = static_cast<const int*>(b_rowptr);
  const int* bcol = static_cast<const int*>(b_colidx);
  long long* o = static_cast<long long*>(out);
  unsigned* dmap = static_cast<unsigned*>(diag);
  const long long words_a = m + k > 1 ? (m + k - 1 + 31) / 32 : 0;
  const long long words_b = k + n > 1 ? (k + n - 1 + 31) / 32 : 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(o, 0, (kFields + 2 * kMaxDiags) * sizeof(long long),
                          s);
  }
  if (err == cudaSuccess && words_a + words_b > 0) {
    err = cudaMemsetAsync(dmap, 0, (words_a + words_b) * sizeof(unsigned), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wide = static_cast<long long>(sms) * 8;  // 8 blocks an SM
  if (m > 0) {
    rows_a<<<grid_for((m + kWarps - 1) / kWarps, wide), kThreads, 0, s>>>(
        arp, acol, brp, m, static_cast<int*>(rows),
        static_cast<int*>(rows) + m, dmap, o);
  }
  if (k > 0) {
    rows_b<<<grid_for((k + kWarps - 1) / kWarps, wide), kThreads, 0, s>>>(
        brp, bcol, k, n, dmap + words_a, o);
  }
  if (words_a + words_b > 0) {
    count_bits<<<grid_for((words_a + words_b + kThreads - 1) / kThreads,
                          wide),
                 kThreads, 0, s>>>(dmap, words_a, words_a + words_b, o);
    list_offsets<<<2, kListThreads, 0, s>>>(dmap, words_a, words_b, m, k, o);
  }
  if (m > 0) {
    fill_segments<<<static_cast<unsigned>((m + kSeg - 1) / kSeg), kThreads,
                    0, s>>>(
        static_cast<const int*>(rows), static_cast<const int*>(rows) + m, m,
        n, o, static_cast<int*>(seg));
    fill_combine<<<1, 1, 0, s>>>(static_cast<const int*>(seg), m, n, o);
  }
  if (bsr) {
    const long long words_k = (k / kBsrBk + 31) / 32;
    const long long words_n = (n / kBsrBk + 31) / 32;
    const long long words = words_k > words_n ? words_k : words_n;
    unsigned* gmap = bsr_slices > 0 ? static_cast<unsigned*>(bsr_map)
                                    : nullptr;
    if (gmap) {
      err = cudaMemsetAsync(gmap, 0, bsr_slices * words * sizeof(unsigned),
                            s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long cap = gmap ? bsr_slices : wide;
    int* blen = static_cast<int*>(bsr_blen);
    const long long b_rows = k / kBsrBk, a_rows = m / kBsrBm;
    if (b_rows > 0) {
      bsr_blocks<<<grid_for(b_rows, cap), kThreads,
                   gmap ? 0 : words_n * sizeof(unsigned), s>>>(
          brp, bcol, b_rows, kBsrBk, gmap ? words : words_n, gmap, nullptr,
          blen, nullptr);
    }
    if (a_rows > 0 && b_rows > 0) {
      bsr_blocks<<<grid_for(a_rows, cap), kThreads,
                   gmap ? 0 : words_k * sizeof(unsigned), s>>>(
          arp, acol, a_rows, kBsrBm, gmap ? words : words_k, gmap, blen,
          nullptr, o + kBsrPairs);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
