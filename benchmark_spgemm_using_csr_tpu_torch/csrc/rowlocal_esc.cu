// K6 — rowlocal_esc for Hopper (sm_90a).
//
// C = A·B in CSR, one block a row of A: the row's products are expanded into
// shared memory, ordered by (column, value bits), the runs of equal columns
// summed with the Hillis–Steele addition tree of sort_merge.cuh, and the
// sums written, columns ascending, at C's exact row offsets. The caller
// gives C's rowptr (K5's counts, scanned on the device: ops/rowlocal).
//
// It replaces no TPU kernel. The chunked ESC path (ops/chunked) expands
// every product of the call into one device-memory stream, sorts it globally
// by an int64 (row, col) key, run-sums it in log2(max_run) passes and
// compacts it into a C sized at a bound; for a matrix whose every row fits
// this kernel, the whole stream is replaced by one pass a row on chip. Its
// plain version is ops/rowlocal.rowlocal_esc_plain.
//
// The result, bit for bit. The tree at lane i of a sorted run adds lane
// i-k's partial where it lies in the run, else +0.0, at k = 1, 2, 4, ... <
// max_run (+0.0 turns a -0.0 partial into +0.0). That depends on the lane's
// offset in its run, not on where the run lies in the row, so a column's sum
// depends only on its products in (value bits) order, and this kernel may
// order the products within each column's bucket alone; the plain version
// sorts the whole stream by (row, column, value bits) and runs the same
// passes over it. Products are a·b rounded once, sums are added in that
// fixed order (no atomics on values), so the result is the same on every run
// and in a CUDA graph replay. Runs at most max_run long (a column of a row
// has at most one product an A entry) sum every product.
//
// What bounds it on the H100: bytes. Least traffic: A once (8 B an entry),
// B's (column, value) once a product (8 B; 16 for float64), C once (8 B an
// entry): at fem_81k 47 + 3,437 + 213 MB = 3.70 GB, 1.1 ms at 3.35 TB/s. B
// (46.7 MB there) lies mostly in the 50 MB L2. A bitonic sort of each row's
// products padded to a power of two (8192 lanes a row at fem_81k: 91 stages)
// would spend ~3·10^10 compare-exchanges a call and pass 64 KB of shared
// memory a stage; this design buckets a row's products by column with one
// hash insert a product and sorts only the columns and each bucket.
//
// Design (one block of T = 64..512 threads a row; all in shared memory):
//   1. expand: windows of T A entries, whose B row lengths are scanned
//      (each product's index in the row); a warp takes an entry, its lanes
//      consecutive entries of the B row (coalesced), and forms a·b;
//   2. bucket: the column goes into an open-addressing hash of the next
//      power of two >= 4·nnz(C row) slots (compare-and-swap on the column;
//      at a quarter full, the lanes of a warp seldom probe twice);
//      an integer atomicAdd on the slot's count gives the product a place
//      in its column's bucket (the order inside a bucket comes later);
//   3. the distinct columns (exactly the row's nnz(C), from rowptr) are
//      bitonic-sorted as (column << 32 | slot) pairs, padded to a power of
//      two: their rank is the column's place in C's row;
//   4. a block scan of the buckets' counts in column order gives each
//      bucket's offset; each product's value bits move to their bucket, and
//      each position is marked with its bucket;
//   5. each position's place in its bucket is the count of the bucket's
//      values below its own (ties by position): neighbouring threads take
//      neighbouring positions, so a warp mostly reads one bucket, each
//      value a broadcast;
//   6. a thread a bucket: the addition tree's value at the bucket's last
//      lane, a pairwise reduction from that lane back (L - 1 adds, and the
//      tree's +0.0s), written as C's entry.
// Shared memory a row (ops/rowlocal.smem_bytes repeats it): the sorted
// columns 8·L (L = pow2 >= U), the hash's columns and counts 8·H (H = pow2 >=
// 4U, at least 32), the bucket offsets 4·(U + 1), then, 16-byte aligned, two
// value arrays and one of bucket ids a product: 12 bytes a product in float32
// (20 in float64). At fem_81k (6,426 products and 375 columns a row at most)
// that is 97 KB: two blocks of 512 threads an SM. The launch takes the most
// any row needs, which the plan computes and keeps within half an SM's
// shared memory: at one block an SM the kernel is starved of warps (on
// circuit_262k's rows, 197 KB a block, it ran 1.5x slower than the stream).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMinTable = 32;
constexpr int kEmpty = -1;
constexpr unsigned kNoSlot = 0xffffffffu;
constexpr int kCountRank = 1024;  // columns ranked by counting, at most

// A value's order-preserving bits (SortVal of sort_merge.cuh: -0.0 below
// +0.0), its raw bits, and its rounded-once arithmetic.
template <typename V>
struct Num;

template <>
struct Num<float> {
  using S = unsigned;
  __device__ __forceinline__ static S order(float v) {
    const int b = __float_as_int(v);
    return static_cast<unsigned>(b ^ ((b >> 31) & 0x7fffffff)) ^ 0x80000000u;
  }
  __device__ __forceinline__ static float unorder(S u) {
    const int b = static_cast<int>(u ^ 0x80000000u);
    return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
  }
  __device__ __forceinline__ static S raw(float v) { return __float_as_uint(v); }
  __device__ __forceinline__ static float val(S u) { return __uint_as_float(u); }
  __device__ __forceinline__ static float mul(float x, float y) {
    return __fmul_rn(x, y);
  }
  __device__ __forceinline__ static float add(float x, float y) {
    return __fadd_rn(x, y);
  }
};

template <>
struct Num<double> {
  using S = unsigned long long;
  __device__ __forceinline__ static S order(double v) {
    const long long b = __double_as_longlong(v);
    return static_cast<S>(b ^ ((b >> 63) & 0x7fffffffffffffffLL)) ^
           0x8000000000000000ULL;
  }
  __device__ __forceinline__ static double unorder(S u) {
    const long long b = static_cast<long long>(u ^ 0x8000000000000000ULL);
    return __longlong_as_double(b ^ ((b >> 63) & 0x7fffffffffffffffLL));
  }
  __device__ __forceinline__ static S raw(double v) {
    return static_cast<S>(__double_as_longlong(v));
  }
  __device__ __forceinline__ static double val(S u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
  __device__ __forceinline__ static double mul(double x, double y) {
    return __dmul_rn(x, y);
  }
  __device__ __forceinline__ static double add(double x, double y) {
    return __dadd_rn(x, y);
  }
};

__device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Inclusive scan of v over the block; synchronises it.
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

// The hash slot of `col`, inserted if new (a compare-and-swap a probe, which
// also reads the slot); -1 if the table is full (never, for a row whose
// distinct columns are at most a quarter of the table).
__device__ __forceinline__ int insert(int* table, int size, int bits,
                                      int col) {
  unsigned s = (static_cast<unsigned>(col) * 2654435769u) >> (32 - bits);
  for (int probe = 0; probe < size; ++probe) {
    const int held = atomicCAS(&table[s], kEmpty, col);
    if (held == kEmpty || held == col) return static_cast<int>(s);
    s = (s + 1) & (size - 1);
  }
  return -1;
}

template <typename V>
__global__ void __launch_bounds__(kMaxThreads, 2) rowlocal_esc_kernel(
    const int* __restrict__ arp, const int* __restrict__ acol,
    const V* __restrict__ aval, const int* __restrict__ brp,
    const int* __restrict__ bcol, const V* __restrict__ bval,
    const int* __restrict__ crp, int* __restrict__ ccol,
    V* __restrict__ cval, int max_run, int smem_bytes) {
  using N = Num<V>;
  using S = typename N::S;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_incl[kMaxThreads];
  __shared__ int s_start[kMaxThreads];
  __shared__ V s_aval[kMaxThreads];
  __shared__ long long s_warp[kMaxThreads / 32];
  __shared__ int s_nu;

  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int row = blockIdx.x;
  const int a0 = arp[row];
  const int a1 = arp[row + 1];
  const int c0 = crp[row];
  const int u = crp[row + 1] - c0;
  if (u <= 0 || a1 <= a0) return;  // the whole block: nothing to write

  // this row's layout (module note); the product arrays' bases depend on
  // the launch's shared memory alone
  const int l2 = pow2_at_least(u);
  const int hsize = pow2_at_least(4 * u > kMinTable ? 4 * u : kMinTable);
  const int hbits = 31 - __clz(hsize);
  auto* list = reinterpret_cast<unsigned long long*>(smem);
  int* hcol = reinterpret_cast<int*>(list + l2);
  int* hcnt = hcol + hsize;  // a slot's count, then its bucket's offset
  int* coff = hcnt + hsize;  // the buckets' offsets in column order, u + 1
  const int head = (8 * l2 + 4 * (2 * hsize + u + 1) + 15) & ~15;
  const long long pcap =
      (smem_bytes - head) / static_cast<long long>(2 * sizeof(S) + 4);
  S* xs = reinterpret_cast<S*>(smem + head);
  S* zs = xs + pcap;
  auto* ys = reinterpret_cast<unsigned*>(zs + pcap);

  for (int s = t; s < hsize; s += nt) {
    hcol[s] = kEmpty;
    hcnt[s] = 0;
  }
  if (t == 0) s_nu = 0;
  __syncthreads();

  // 1-2. expand and bucket: xs the value's order bits, ys (slot << 16 | its
  // place in the bucket)
  long long walked = 0;
  for (int base = a0; base < a1; base += nt) {
    const int e = base + t;
    long long len = 0;
    int start = 0;
    V av = V(0);
    if (e < a1) {
      const int c = acol[e];
      start = brp[c];
      len = brp[c + 1] - start;
      av = aval[e];
    }
    const long long incl = block_scan(len, s_warp);
    s_incl[t] = incl;
    s_start[t] = start;
    s_aval[t] = av;
    __syncthreads();
    const long long total = s_incl[nt - 1];
    // a warp an A entry, its lanes on consecutive entries of the B row
    const int lane = t & 31;
    const int n_e = a1 - base < nt ? a1 - base : nt;
    for (int j = t >> 5; j < n_e; j += nt >> 5) {
      const long long before = j ? s_incl[j - 1] : 0;
      const int blen = static_cast<int>(s_incl[j] - before);
      const int st = s_start[j];
      const V av = s_aval[j];
      for (int i = lane; i < blen; i += 32) {
        const int col = bcol[st + i];
        const V v = N::mul(av, bval[st + i]);
        const long long idx = walked + before + i;
        if (idx >= pcap) continue;  // never, for the plan's matrix
        const int slot = insert(hcol, hsize, hbits, col);
        unsigned sp = kNoSlot;
        if (slot >= 0) {
          sp = static_cast<unsigned>(slot) << 16 |
               static_cast<unsigned>(atomicAdd(&hcnt[slot], 1));
        }
        xs[idx] = N::order(v);
        ys[idx] = sp;
      }
    }
    walked += total;
    __syncthreads();
  }
  const long long np = walked < pcap ? walked : pcap;

  // 3. the distinct columns, sorted
  for (int s = t; s < hsize; s += nt) {
    const int c = hcol[s];
    if (c != kEmpty) {
      const int r = atomicAdd(&s_nu, 1);
      if (r < l2) {
        list[r] = static_cast<unsigned long long>(static_cast<unsigned>(c))
                      << 32 |
                  static_cast<unsigned>(s);
      }
    }
  }
  __syncthreads();
  const int nu = s_nu < l2 ? s_nu : l2;
  if (nu <= kCountRank) {
    // a column's rank is the count of columns below it (all distinct; each
    // read is a broadcast); the sorted list goes where the hash's columns
    // were (4·H >= 8·U bytes), read no more
    auto* sorted = reinterpret_cast<unsigned long long*>(hcol);
    for (int r = t; r < nu; r += nt) {
      const unsigned long long x = list[r];
      int rank = 0;
      for (int m = 0; m < nu; ++m) rank += list[m] < x;
      sorted[rank] = x;
    }
    __syncthreads();
    list = sorted;
  } else {
    for (int r = nu + t; r < l2; r += nt) list[r] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= l2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < l2; i += nt) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long x = list[i];
            const unsigned long long y = list[ixj];
            if ((x > y) == ((i & k) == 0)) {
              list[i] = y;
              list[ixj] = x;
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // 4. the buckets' offsets in column order, then each product's order
  // bits to its bucket, in zs
  const int per = (nu + nt - 1) / nt;
  const int r0 = t * per < nu ? t * per : nu;
  const int r1 = r0 + per < nu ? r0 + per : nu;
  long long own = 0;
  for (int r = r0; r < r1; ++r) own += hcnt[static_cast<unsigned>(list[r])];
  const long long incl = block_scan(own, s_warp);
  long long run = incl - own;
  for (int r = r0; r < r1; ++r) {
    coff[r] = static_cast<int>(run);
    run += hcnt[static_cast<unsigned>(list[r])];
  }
  if (t == nt - 1) coff[nu] = static_cast<int>(incl);
  __syncthreads();
  for (int r = t; r < nu; r += nt) {
    hcnt[static_cast<unsigned>(list[r])] = coff[r];
  }
  __syncthreads();
  for (long long i = t; i < np; i += nt) {
    const unsigned sp = ys[i];
    if (sp == kNoSlot) continue;
    zs[hcnt[sp >> 16] + (sp & 0xffffu)] = xs[i];
  }
  __syncthreads();
  // each position's bucket in ys: a warp a bucket
  for (int r = t >> 5; r < nu; r += nt >> 5) {
    for (int q = coff[r] + (t & 31); q < coff[r + 1]; q += 32) {
      ys[q] = static_cast<unsigned>(r);
    }
  }
  __syncthreads();

  // 5. each bucket ordered by its value bits: a position's place is the
  // count of its bucket's values below it (ties by position), so the
  // threads of a warp, on neighbouring positions, mostly read one bucket;
  // xs takes the values (a position's bucket in ys stays right)
  const int nz = coff[nu];
  for (int q = t; q < nz; q += nt) {
    const int r = static_cast<int>(ys[q]);
    const int o = coff[r];
    const int len = coff[r + 1] - o;
    const S v = zs[q];
    const int at = q - o;
    int place = 0;
    int p = 0;
    for (; p + 4 <= len; p += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const S w = zs[o + p + i];
        place += (w < v) || (w == v && p + i < at);
      }
    }
    for (; p < len; ++p) {
      const S w = zs[o + p];
      place += (w < v) || (w == v && p < at);
    }
    xs[o + place] = N::raw(N::unorder(v));
  }
  __syncthreads();

  // 6. a thread a bucket: the tree's value at its last lane, then C's
  // entry. After the passes k = 1, 2, ... < max_run, lane q holds its
  // partial of the step before plus lane q-k's (or +0.0 where that lies
  // before the bucket), so the last lane's value is a pairwise reduction
  // from that lane back: at step k, partial m (lane L-1-m·k) adds partial
  // 2m+1 of the step before to partial 2m, or +0.0 past the bucket's start;
  // once k reaches L only +0.0 is added, and once is the same as many
  const int rows_out = nu < u ? nu : u;
  for (int r = t; r < rows_out; r += nt) {
    const int o = coff[r];
    const int len = coff[r + 1] - o;
    S* w = xs + o + len - 1;  // partial m at w[-m]
    int n = len;
    for (int half = 1; half < max_run && half < len; half <<= 1) {
      const int next = (n + 1) >> 1;
      for (int m = 0; m < next; ++m) {
        const V right = 2 * m + 1 < n ? N::val(w[-(2 * m + 1)]) : V(0);
        w[-m] = N::raw(N::add(N::val(w[-2 * m]), right));
      }
      n = next;
    }
    V sum = N::val(w[0]);
    if (pow2_at_least(len) < max_run) sum = N::add(sum, V(0));
    ccol[c0 + r] = static_cast<int>(list[r] >> 32);
    cval[c0 + r] = sum;
  }
}

struct Args {
  const void* arp;
  const void* acol;
  const void* aval;
  const void* brp;
  const void* bcol;
  const void* bval;
  const void* crp;
  void* ccol;
  void* cval;
  long long m;
  int threads;
  int smem;
  int max_run;
  cudaStream_t stream;
};

template <typename V>
int launch(const Args& x) {
  const auto kernel = rowlocal_esc_kernel<V>;
  if (x.smem > 48 * 1024) {
    // an attribute, not a stream operation: set it outside a capture (the
    // graphs capture a body only after its eager first call has run)
    cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
    cudaError_t err = cudaStreamIsCapturing(x.stream, &capturing);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (capturing == cudaStreamCaptureStatusNone) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, x.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  kernel<<<static_cast<unsigned>(x.m), x.threads, x.smem, x.stream>>>(
      static_cast<const int*>(x.arp), static_cast<const int*>(x.acol),
      static_cast<const V*>(x.aval), static_cast<const int*>(x.brp),
      static_cast<const int*>(x.bcol), static_cast<const V*>(x.bval),
      static_cast<const int*>(x.crp), static_cast<int*>(x.ccol),
      static_cast<V*>(x.cval), x.max_run, x.smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a CUDA error code (0 on success). The caller
// allocates every buffer, contiguous on one device: A's rowptr (m + 1) and
// colidx int32, its values; B's rowptr and colidx int32, its values; C's
// rowptr (m + 1, int32, exact), colidx (int32) and values (at least C's
// nnz). Values are float32 (is_double 0) or float64 (is_double 1) alike.
// threads is a power of two in 64..512; smem the dynamic shared memory a
// block, at least what every row needs (module note); max_run >= every
// column's products in a row (the addition tree's bound).
extern "C" int rowlocal_esc_launch(const void* a_rowptr, const void* a_colidx,
                                   const void* a_vals, const void* b_rowptr,
                                   const void* b_colidx, const void* b_vals,
                                   const void* c_rowptr, void* c_colidx,
                                   void* c_vals, long long m, int threads,
                                   int smem, int max_run, int is_double,
                                   void* stream) {
  if (m < 0 || m > 0x7fffffffLL || threads < 64 || threads > kMaxThreads ||
      (threads & (threads - 1)) != 0 || smem < 0 || max_run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const Args x{a_rowptr, a_colidx, a_vals, b_rowptr, b_colidx, b_vals,
               c_rowptr, c_colidx, c_vals, m,        threads,  smem,
               max_run,  static_cast<cudaStream_t>(stream)};
  return is_double ? launch<double>(x) : launch<float>(x);
}
