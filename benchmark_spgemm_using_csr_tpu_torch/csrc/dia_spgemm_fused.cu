// K3 — dia_spgemm_fused for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmark_spgemm_using_csr_tpu/ops/dia_pallas.py:57
// ::dia_spgemm_fused (Pallas kernel _dia_kernel): C = A @ B on diagonal
// planes,
//     C[p][j] = sum over the terms (s1, s2, d2) of output plane p of
//               A[s1][j - d2] * B[s2][j],
// where A is (nd_a, k), B is (nd_b, n), C is (nd_c, n), all row-major, and
// A reads outside [0, k) are 0. Each plane's terms are added in ascending s2,
// the order of both reference forms.
//
// What bounds it on the H100: bytes. The least traffic is each plane read or
// written once, (nd_a + nd_b + nd_c) * n * sizeof(T); the arithmetic, 2
// flops per term and slot, is far below the fp32 rate. A kernel that reads
// A and B once per term moves 2 * terms * n * sizeof(T) from L2 to the SMs,
// 2-27x the least on the suite's DIA matrices. The Pallas kernel kept every
// plane of a column block in VMEM; a block here has at most 227 KB of shared
// memory, so it stages only what its terms read.
//
// Design. The host plan (ops/dia_kernels.launch_plan, cached per offset pair
// and shape) cuts B's sorted offsets into clusters of near offsets, the
// output planes into groups of about equal term counts and the columns into
// tiles; for each group it lists the rows a block stages: B's rows and, per
// cluster, the A rows its terms read, each as one window [j0 - d2max,
// j0 + tile - d2min) of the A plane, 16-byte aligned. It cuts each group
// into items of kItem consecutive planes and writes, per item, one entry
// per B row its planes read (ascending s2): the byte offsets in shared
// memory of that B row and of each plane's A window at its term's shift.
// A block (one group, one tile; 8 or 16 warps) copies its rows, entries and
// item list into shared memory with cp.async, 16 bytes a lane where the
// planes are aligned (zero-filled outside the planes), so A and B cross
// L2 -> SM about once per group plus the windows' halos (0.9-2.8x the least
// bytes on the suite). Then each warp takes one item and 32 * V columns at a
// time: a lane keeps kItem * V output slots in registers, loads each entry's
// B value once for the item's planes, and C is written once, coalesced.
// The plan keeps a block within 112 KB of shared memory and the launch
// bounds hold the staged kernel to 64 registers a thread at 16 warps, so
// two blocks share an SM (the occupancy query says so for every suite
// plan). Their copies and sums still barely overlap: on the 99-diagonal
// FEM planes the copies alone plus the sums alone (about 1.4 loads from
// shared memory per term and slot) come to about the whole, and neither
// is HBM-bound (PERF.md). Where even one plane's rows overflow a block's
// shared memory at the narrowest tile, the plan picks the direct mode of
// the same kernel: A and B read from global memory, a warp per plane and
// 32 * V columns, each of the block's warps on its own columns.
//
// Bit-equality: every sum starts from -0.0 (-0.0 + x == x for every x) and
// adds the terms in ascending s2 with __fmul_rn / __fadd_rn (__dmul_rn /
// __dadd_rn), so nvcc cannot contract a multiply-add into an FMA: the result
// equals the plain PyTorch version bit for bit. Offsets into the planes are
// 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDirectWarps = 8;  // the direct mode's block: 256 threads
constexpr int kStaticSmem = 48 * 1024;  // above this, opt in per kernel
constexpr int kItem = 3;  // planes a warp sums at once (PLANES_PER_ITEM)

__device__ __forceinline__ float mul_rn(float x, float y) {
  return __fmul_rn(x, y);
}
__device__ __forceinline__ double mul_rn(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ float add_rn(float x, float y) {
  return __fadd_rn(x, y);
}
__device__ __forceinline__ double add_rn(double x, double y) {
  return __dadd_rn(x, y);
}

// One element (4, 8 or 16 bytes) from global to shared memory,
// asynchronously; zero-filled (and src not read) when !valid.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src,
                                           bool valid = true) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8 || sizeof(T) == 16, "");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The plan's per-group row (ops/dia_kernels.LaunchPlan.groups).
struct Group {
  int plane0, nplanes, row0, nb, na, term0, nterms, terms_at;
};

__device__ __forceinline__ Group load_group(const int* groups, int g) {
  const int4* p = reinterpret_cast<const int4*>(groups) + 2 * g;
  const int4 x = p[0];
  const int4 y = p[1];
  return Group{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
}

// The sums of N entries of an item: acc[q][v] += A * B for each plane q of
// the item that has a term at the entry's B row, for the lane's V slots.
// An entry holds byte offsets from base (the lane's first slot in the row
// buffer): B's row, then each plane's A window at its shift, or -1. Every
// load first, then the sums in entry order (ascending B slot).
template <typename T, int V, int N>
__device__ __forceinline__ void add_entries(T (&acc)[kItem][V],
                                            const char* base,
                                            const int4 (&e)[N]) {
  T bv[N][V], av[N][kItem][V];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int off[kItem] = {e[i].y, e[i].z, e[i].w};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bv[i][v] = *reinterpret_cast<const T*>(base + e[i].x +
                                             32 * v * sizeof(T));
    }
#pragma unroll
    for (int q = 0; q < kItem; ++q) {
      if (off[q] >= 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          av[i][q][v] = *reinterpret_cast<const T*>(base + off[q] +
                                                    32 * v * sizeof(T));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int off[kItem] = {e[i].y, e[i].z, e[i].w};
#pragma unroll
    for (int q = 0; q < kItem; ++q) {
      if (off[q] >= 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[q][v] = add_rn(acc[q][v], mul_rn(av[i][q][v], bv[i][v]));
        }
      }
    }
  }
}

// Stage one row: width elements of plane from column col0 on (zero outside
// [0, len)) to dst; the lanes of a warp split it. With vec, col0, len and
// width are multiples of 16 bytes' worth and plane is 16-byte aligned, so
// each lane copies 16 bytes at a time, whole inside or whole outside.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* plane,
                                          long long col0, long long len,
                                          int width, bool vec, int lane,
                                          const T* any) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    for (int x = lane * E; x < width; x += 32 * E) {
      const long long col = col0 + x;
      const bool valid = col >= 0 && col < len;
      copy_async(reinterpret_cast<int4*>(dst + x),
                 reinterpret_cast<const int4*>(valid ? plane + col : any),
                 valid);
    }
  } else {
    for (int x = lane; x < width; x += 32) {
      const long long col = col0 + x;
      const bool valid = col >= 0 && col < len;
      copy_async(dst + x, valid ? plane + col : any, valid);
    }
  }
}

// The sums of the group's planes on the tile at column j0 from the rows
// staged at rows: a warp per unit of work, (item, 32 * V columns), the
// heaviest items first; entries read in batches of kBatch (then one by
// one).
template <typename T, int V, int W>
__device__ __forceinline__ void sum_tile(T* __restrict__ c, const char* rows,
                                         const int4* entries,
                                         const int4* items, int nitems,
                                         const Group& g, long long j0,
                                         int tile, long long n, int warp,
                                         int lane) {
  constexpr int kBatch = 4 / V > 1 ? 4 / V : 1;
  const int chunks = tile / (32 * V);
  for (int unit = warp; unit < nitems * chunks; unit += W) {
    const int4 item = items[unit / chunks];  // first plane, planes, entries
    const int jl = (unit % chunks) * 32 * V + lane;
    const char* base = rows + jl * static_cast<int>(sizeof(T));
    T acc[kItem][V];
#pragma unroll
    for (int q = 0; q < kItem; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = -T(0);
    }
    int t = item.z;
    for (; t + kBatch <= item.w; t += kBatch) {
      int4 e[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) e[i] = entries[t + i];
      add_entries<T, V, kBatch>(acc, base, e);
    }
    for (; t < item.w; ++t) {
      const int4 e[1] = {entries[t]};
      add_entries<T, V, 1>(acc, base, e);
    }
    const long long col = j0 + jl;
#pragma unroll
    for (int q = 0; q < kItem; ++q) {
      if (q < item.y) {
        T* out = c + static_cast<long long>(g.plane0 + item.x + q) * n + col;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (col + 32 * v < n) out[32 * v] = acc[q][v];
        }
      }
    }
  }
}

// A block computes one plane group on one tile. Its shared memory holds
// the staged rows (terms_at bytes), then the group's entry table and its
// item list; all three are copied at once. Two blocks per SM asked of the
// register allocator: at one, the float64 16-warp instances take 96-104
// registers and one block per SM.
template <typename T, int V, int W>
__global__ void __launch_bounds__(32 * W, 2)
    dia_spgemm_kernel_staged(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    const int* __restrict__ groups, const int4* __restrict__ rows,
    const int4* __restrict__ plane_terms, const int4* __restrict__ terms,
    int ngroups, int tile, long long k, long long n, bool vec) {
  extern __shared__ __align__(16) char smem[];
  const Group g = load_group(groups, static_cast<int>(blockIdx.x % ngroups));
  const long long j0 = static_cast<long long>(blockIdx.x / ngroups) * tile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int4* entries = reinterpret_cast<int4*>(smem + g.terms_at);
  int4* items = entries + g.nterms;
  const int nitems = (g.nplanes + kItem - 1) / kItem;
  for (int i = threadIdx.x; i < g.nterms; i += 32 * W) {
    copy_async(entries + i, terms + g.term0 + i);
  }
  for (int i = threadIdx.x; i < nitems; i += 32 * W) {
    copy_async(items + i, plane_terms + g.plane0 + i);
  }
  // the rows, B's tile then the A windows, a warp per row; each warp reads
  // the descriptors of 32 of its rows at once, a lane each, and passes
  // them round by shuffles
  const int nrows = g.nb + g.na;
  T* stage = reinterpret_cast<T*>(smem);
  for (int r0 = warp; r0 < nrows; r0 += 32 * W) {
    const int mine = r0 + lane * W;
    const int4 own = mine < nrows ? rows[g.row0 + mine] : make_int4(0, 0, 0, 0);
    for (int i = 0; i < 32 && r0 + i * W < nrows; ++i) {
      const int slot = __shfl_sync(0xffffffffu, own.x, i);
      const int shift = __shfl_sync(0xffffffffu, own.y, i);
      const int width = __shfl_sync(0xffffffffu, own.z, i);
      const int at = __shfl_sync(0xffffffffu, own.w, i);
      const bool is_b = r0 + i * W < g.nb;
      const long long len = is_b ? n : k;
      stage_row(stage + at, (is_b ? b : a) + static_cast<long long>(slot) * len,
                j0 - shift, len, width, vec, lane, b);
    }
  }
  wait_async();
  __syncthreads();
  sum_tile<T, V, W>(c, smem, entries, items, nitems, g, j0, tile, n, warp,
                    lane);
}

template <typename T, int V>
__global__ void __launch_bounds__(32 * kDirectWarps) dia_spgemm_kernel_direct(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    const int* __restrict__ groups, const int4* __restrict__ plane_terms,
    const int4* __restrict__ terms, int ngroups, int tile, long long k,
    long long n) {
  const Group g = load_group(groups, static_cast<int>(blockIdx.x % ngroups));
  const long long j0 = static_cast<long long>(blockIdx.x / ngroups) * tile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = tile / (32 * V);
  for (int item = warp; item < g.nplanes * chunks; item += kDirectWarps) {
    const int p = item / chunks;
    const long long col = j0 + (item - p * chunks) * 32 * V + lane;
    const int4 range = plane_terms[g.plane0 + p];  // 0, 1, first, end
    T acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = -T(0);
    for (int t = range.z; t < range.w; ++t) {
      const int4 term = terms[t];  // s1, s2, d2
      const T* pa = a + static_cast<long long>(term.x) * k;
      const T* pb = b + static_cast<long long>(term.y) * n;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long j = col + 32 * v;
        if (j < n) {
          const long long ja = j - term.z;
          const T av = (ja >= 0 && ja < k) ? pa[ja] : T(0);
          acc[v] = add_rn(acc[v], mul_rn(av, pb[j]));
        }
      }
    }
    T* out = c + static_cast<long long>(g.plane0 + p) * n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (col + 32 * v < n) out[32 * v] = acc[v];
    }
  }
}

struct Args {
  const void *a, *b;
  void* c;
  const void *groups, *rows, *plane_terms, *terms;
  int ngroups;
  long long ntiles;
  int tile;
  long long k, n;
  int smem;
  bool staged;
  cudaStream_t stream;
  int* blocks_per_sm;  // not null: the occupancy query, no launch
};

template <typename T, int V, int W>
int launch(const Args& x) {
  const long long blocks = x.ngroups * x.ntiles;
  if (blocks > 0x7fffffffLL || x.tile % (32 * V) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* a = static_cast<const T*>(x.a);
  const T* b = static_cast<const T*>(x.b);
  T* c = static_cast<T*>(x.c);
  const int* groups = static_cast<const int*>(x.groups);
  const int4* plane_terms = static_cast<const int4*>(x.plane_terms);
  const unsigned grid = static_cast<unsigned>(blocks);
  // rows copied 16 bytes at a time where the planes allow it
  constexpr long long E = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 && x.k % E == 0 &&
                   x.n % E == 0;
  if (x.staged) {
    auto kernel = dia_spgemm_kernel_staged<T, V, W>;
    if (x.smem > kStaticSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, x.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (x.blocks_per_sm) {
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          x.blocks_per_sm, kernel, 32 * W, x.smem));
    }
    kernel<<<grid, 32 * W, x.smem, x.stream>>>(
        a, b, c, groups, static_cast<const int4*>(x.rows), plane_terms,
        static_cast<const int4*>(x.terms), x.ngroups, x.tile, x.k, x.n, vec);
  } else if (x.blocks_per_sm) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        x.blocks_per_sm, dia_spgemm_kernel_direct<T, V>, 32 * kDirectWarps,
        0));
  } else {
    dia_spgemm_kernel_direct<T, V><<<grid, 32 * kDirectWarps, 0, x.stream>>>(
        a, b, c, groups, plane_terms, static_cast<const int4*>(x.terms),
        x.ngroups, x.tile, x.k, x.n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_lanes(const Args& x, int lanes) {
  switch (lanes) {
    case 1: return launch<T, 1, W>(x);
    case 2: return launch<T, 2, W>(x);
    case 4: return launch<T, 4, W>(x);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_warps(const Args& x, int lanes, int warps) {
  if (!x.staged) return launch_lanes<T, kDirectWarps>(x, lanes);
  switch (warps) {
    case 8: return launch_lanes<T, 8>(x, lanes);
    case 16: return launch_lanes<T, 16>(x, lanes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer, all contiguous on one device: a (nd_a, k), b
// (nd_b, n) and c (nd_c, n) of float (is_double == 0) or double, and the
// plan's int32 tables (ops/dia_kernels.LaunchPlan): groups (ngroups, 8),
// rows (R, 4), plane_terms (nd_c, 4) and terms (E, 4). The grid is
// ngroups * ntiles blocks: staged, of 32 * warps (8 or 16) threads with
// smem bytes of dynamic shared memory (at most 227 KB); direct, of 256
// threads. A warp covers 32 * lanes (1, 2 or 4) columns and tile is a
// multiple of that.
extern "C" int dia_spgemm_fused_launch(
    const void* a, const void* b, void* c, const void* groups,
    const void* rows, const void* plane_terms, const void* terms, int ngroups,
    long long ntiles, int tile, long long k, long long n, int smem, int lanes,
    int warps, int staged, int is_double, void* stream) {
  if (ngroups < 0 || ntiles < 0 || tile <= 0 || k < 0 || n < 0 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ngroups == 0 || ntiles == 0 || n == 0) return 0;
  const Args x{a, b, c, groups, rows, plane_terms, terms, ngroups, ntiles,
               tile, k, n, smem, staged != 0,
               static_cast<cudaStream_t>(stream), nullptr};
  return is_double ? launch_warps<double>(x, lanes, warps)
                   : launch_warps<float>(x, lanes, warps);
}

// How many blocks of the launch shape (smem, lanes, warps, staged,
// is_double as for dia_spgemm_fused_launch) one SM holds at once, into
// *blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current
// device); returns a CUDA error code. Launches nothing.
extern "C" int dia_spgemm_fused_occupancy(int smem, int lanes, int warps,
                                          int staged, int is_double,
                                          int* blocks) {
  if (smem < 0 || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args x{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               1, 1, 32 * lanes, 0, 0, smem, staged != 0, nullptr, blocks};
  return is_double ? launch_warps<double>(x, lanes, warps)
                   : launch_warps<float>(x, lanes, warps);
}
