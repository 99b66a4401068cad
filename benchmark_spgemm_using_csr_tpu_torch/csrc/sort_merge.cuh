// Shared core of K1 (tile_sort_merge.cu) and K2 (bin_sort_compress.cu): the
// per-row sort, duplicate merge and tail scan of the reference's Pallas
// kernels (benchmark_spgemm_using_csr_tpu/ops/pallas_kernels.py,
// _bitonic_stage and the Hillis–Steele loops of _sort_compress_kernel and
// _tile_sort_merge_kernel).
//
// A row of W lanes (a power of two, 2..2048) lives in registers: T = W / E
// threads own it, thread t the E consecutive lanes t*E .. t*E + E - 1, with
// E = min(W, 8) (Geom): 8 lanes keep a thread near 64 registers, so 4
// blocks of 256 threads fit an SM; more lanes per thread cost warps.
// Everything is a template on W and fully unrolled, so every register index
// is a constant and nothing spills to local memory.
//
// 1. Bitonic sort by (key, val), lexicographic on signed int32 keys, in its
//    ascending-only form: each merge starts with a flip stage (lane i
//    against i ^ (size - 1)) and every pair keeps the smaller in its lower
//    lane, so no stage needs a direction bit. A float value sorts as its
//    order-preserving bits, so a compare is one 64-bit integer compare
//    (SortVal). A stage whose highest flipped lane bit is below E is a
//    compare-exchange inside the thread's registers; from E up to 32*E a
//    __shfl_xor_sync exchange inside the warp; from 32*E (rows that span
//    several warps, W >= 512) an exchange through shared memory with one
//    block barrier: the exchanges alternate between two buffers, so a
//    buffer is only rewritten after the next barrier.
// 2. Segmented run-sum with the Pallas addition tree: at steps k = 1, 2, 4,
//    ... every lane adds lane i-k's partial if the keys are equal and +0.0
//    otherwise (always adding, so -0.0 turns +0.0), which keeps the values
//    bit-equal to the plain version. Lane i-k lies in the thread's own
//    registers, or in thread t-1 (k < E) or t - k/E (k >= E): in a row of
//    one warp or less that is a __shfl_up_sync. In a row of several warps the
//    first threads of every warp need the previous warp's partials at every
//    step, so there each step goes through shared memory, one barrier each.
// 3. Run tails (the last lane of a run of keys below the sentinel) and the
//    inclusive count of tails: an integer, so in-thread sums, a warp scan and,
//    for a row of several warps, per-warp totals in shared memory.
//
// A row of W <= 32*E lanes passes no block barrier: rows of a block that fit
// in one warp never wait for each other. A wider row passes one barrier per
// shared-memory sort stage (1, 3, 6 at W = 512, 1024, 2048) and log2(W) for
// the run-sum. Every thread of a warp calls every shuffle (the full mask):
// rows past the end of the last block sort sentinels and store nothing.
#pragma once

namespace sort_merge {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kBlockThreads = 256;  // threads per block, several rows each
constexpr int kMaxWarpsPerRow = 8;  // W / E <= 256 threads

template <int W>
struct Geom {
  static_assert(W >= 2 && W <= 2048 && (W & (W - 1)) == 0,
                "W is a power of two in 2..2048");
  static constexpr int E = W < 8 ? W : 8;  // lanes per thread
  static constexpr int T = W / E;          // threads per row
  static constexpr bool kWide = T > kWarp;  // the row spans several warps
};

// Shared memory of one row: none for a row inside one warp; for a wider row
// two buffers of W keys and W values, and the per-warp tail counts.
template <typename V, int W>
__host__ __device__ constexpr int scratch_bytes() {
  return Geom<W>::kWide
             ? 2 * W * static_cast<int>(sizeof(int) + sizeof(V)) +
                   kMaxWarpsPerRow * static_cast<int>(sizeof(int))
             : 0;
}

// One thread's E lanes of a row.
template <typename V, int W>
struct Row {
  static constexpr int E = Geom<W>::E;
  int key[E];
  V val[E];     // the lane's value; after sort_merge_row its run-sum
  int incl[E];  // after sort_merge_row: tails up to and including the lane
  bool tail[E];
};

// The shared-memory buffers of a wide row, laid out [e][t] (lane t*E + e at
// e*T + t) so a warp's accesses are conflict-free.
template <typename V, int W>
struct Scratch {
  int* key;         // buffer p's keys at key + p * W
  V* val;           // buffer p's values at val + p * W
  int* warp_tails;  // kMaxWarpsPerRow
  int p;  // the sort's next exchange writes buffer p; the run-sum's
          // published partials lie in buffer p

  __device__ __forceinline__ explicit Scratch(unsigned char* base)
      : key(reinterpret_cast<int*>(base)),
        val(reinterpret_cast<V*>(key + 2 * W)),
        warp_tails(reinterpret_cast<int*>(val + 2 * W)),
        p(0) {}
};

// What the sort compares: (key, val) lexicographically, on signed int32 keys.
// A float value sorts as its order-preserving bits, so that the pair is one
// 64-bit integer compare; a double sorts as itself. The bits order -0.0
// below +0.0, which changes no sum: values of one key that a float compare
// calls equal are +-0.0, and their sum does not depend on their order.
template <typename V>
struct SortVal {
  using type = V;
  __device__ __forceinline__ static V to(V v) { return v; }
  __device__ __forceinline__ static V from(V v) { return v; }
};

template <>
struct SortVal<float> {
  using type = unsigned;
  __device__ __forceinline__ static unsigned to(float v) {
    const int b = __float_as_int(v);
    return static_cast<unsigned>(b ^ ((b >> 31) & 0x7fffffff)) ^ 0x80000000u;
  }
  __device__ __forceinline__ static float from(unsigned u) {
    const int b = static_cast<int>(u ^ 0x80000000u);
    return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
  }
};

__device__ __forceinline__ long long pair64(int k, unsigned u) {
  return static_cast<long long>(
      static_cast<unsigned long long>(static_cast<unsigned>(k)) << 32 | u);
}

__device__ __forceinline__ bool greater(int ka, unsigned ua, int kb,
                                        unsigned ub) {
  return pair64(ka, ua) > pair64(kb, ub);
}

__device__ __forceinline__ bool greater(int ka, double va, int kb,
                                        double vb) {
  return ka > kb || (ka == kb && va > vb);
}

// The lane keeps the smaller of the pair (want_min) or the larger: it takes
// its partner's (key, val) iff the upper lane's pair is strictly below the
// lower lane's. Both lanes test that one inequality, so they agree, and the
// pair is exchanged as a whole (equal pairs stay).
template <typename S>
__device__ __forceinline__ void exchange(int& k, S& v, int pk, S pv,
                                         bool want_min) {
  if (want_min ? greater(k, v, pk, pv) : greater(pk, pv, k, v)) {
    k = pk;
    v = pv;
  }
}

// One stage of the sort; every pair keeps the smaller in its lower lane.
// HALF is the highest lane bit the stage flips: a flip stage (FLIP, the
// first of each merge, HALF = size / 2) pairs lane i with i ^ (2 * HALF - 1),
// a half-cleaner lane i with i ^ HALF. The lower lane has bit HALF clear.
template <typename S, int W, int HALF, bool FLIP>
__device__ __forceinline__ void sort_stage(int (&k)[Geom<W>::E],
                                           S (&v)[Geom<W>::E], int t,
                                           unsigned char* sk_base, S* sv_base,
                                           int& p) {
  constexpr int E = Geom<W>::E;
  constexpr int T = Geom<W>::T;
  if constexpr (HALF < E) {  // inside the thread
    constexpr int mask = FLIP ? 2 * HALF - 1 : HALF;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & HALF) continue;
      const int f = e ^ mask;
      if (greater(k[e], v[e], k[f], v[f])) {
        const int kk = k[e];
        const S vv = v[e];
        k[e] = k[f];
        v[e] = v[f];
        k[f] = kk;
        v[f] = vv;
      }
    }
  } else {
    // the partner: thread t ^ m, its element e ^ (E - 1) in a flip
    constexpr int m = FLIP ? 2 * HALF / E - 1 : HALF / E;
    constexpr int emask = FLIP ? E - 1 : 0;
    const bool lower = (t & (HALF / E)) == 0;
    int pk[E];
    S pv[E];
    if constexpr (HALF < kWarp * E) {  // inside the warp
#pragma unroll
      for (int e = 0; e < E; ++e) {
        pk[e] = __shfl_xor_sync(kFullMask, k[e ^ emask], m);
        pv[e] = __shfl_xor_sync(kFullMask, v[e ^ emask], m);
      }
    } else {  // across warps of the row
      int* sk = reinterpret_cast<int*>(sk_base) + p * W;
      S* sv = sv_base + p * W;
      p ^= 1;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sk[e * T + t] = k[e];
        sv[e * T + t] = v[e];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < E; ++e) {
        pk[e] = sk[(e ^ emask) * T + (t ^ m)];
        pv[e] = sv[(e ^ emask) * T + (t ^ m)];
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) exchange(k[e], v[e], pk[e], pv[e], lower);
  }
}

// Bitonic sort, ascending only: merges of size 2 .. W, each a flip stage
// (HALF = SIZE / 2) and half-cleaners HALF = SIZE / 4 .. 1.
template <typename S, int W, int SIZE, int HALF>
__device__ __forceinline__ void bitonic_sort(int (&k)[Geom<W>::E],
                                             S (&v)[Geom<W>::E], int t,
                                             unsigned char* sk_base,
                                             S* sv_base, int& p) {
  sort_stage<S, W, HALF, 2 * HALF == SIZE>(k, v, t, sk_base, sv_base, p);
  if constexpr (HALF > 1) {
    bitonic_sort<S, W, SIZE, HALF / 2>(k, v, t, sk_base, sv_base, p);
  } else if constexpr (SIZE < W) {
    bitonic_sort<S, W, 2 * SIZE, SIZE>(k, v, t, sk_base, sv_base, p);
  }
}

// One step of the run-sum: every lane i adds lane i-K's partial where the
// keys are equal, else +0.0. A wide row reads the partials the previous step
// published in buffer s.p and the keys in skey; it publishes its own for the
// next step (one barrier) unless this is the last.
template <typename V, int W, int K>
__device__ __forceinline__ void runsum_step(Row<V, W>& r, int t,
                                            Scratch<V, W>& s,
                                            const int* skey) {
  constexpr int E = Geom<W>::E;
  constexpr int T = Geom<W>::T;
  constexpr int d = K < E ? 1 : K / E;  // the thread that holds lane i-K
  int pk[E];
  V pr[E];
  const bool from_thread = t >= d;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (K < E && e >= K) {  // in this thread
      pk[e] = r.key[e - K];
      pr[e] = r.val[e - K];
      continue;
    }
    const int se = K < E ? e + E - K : e;  // its lane index in thread t - d
    if constexpr (Geom<W>::kWide) {
      const int idx = se * T + (from_thread ? t - d : t);
      pk[e] = skey[idx];
      pr[e] = s.val[s.p * W + idx];
    } else if constexpr (T > 1) {
      pk[e] = __shfl_up_sync(kFullMask, r.key[se], d, T);
      pr[e] = __shfl_up_sync(kFullMask, r.val[se], d, T);
    } else {
      pk[e] = 0;
      pr[e] = V(0);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool ok = (K < E && e >= K) || (T > 1 && from_thread);
    r.val[e] = r.val[e] + ((ok && pk[e] == r.key[e]) ? pr[e] : V(0));
  }
  if constexpr (Geom<W>::kWide && 2 * K < W) {
    s.p ^= 1;
    V* sv = s.val + s.p * W;
#pragma unroll
    for (int e = 0; e < E; ++e) sv[e * T + t] = r.val[e];
    __syncthreads();
  }
  if constexpr (2 * K < W) runsum_step<V, W, 2 * K>(r, t, s, skey);
}

// Sort the row, then fill r.val with the run-sums, r.tail and r.incl.
// `scratch` is the row's scratch_bytes<V, W>() of shared memory (unused for a
// row inside one warp). Every thread of the block calls it.
template <typename V, int W>
__device__ __forceinline__ void sort_merge_row(Row<V, W>& r, int t,
                                               int sentinel,
                                               unsigned char* scratch) {
  constexpr int E = Geom<W>::E;
  constexpr int T = Geom<W>::T;
  Scratch<V, W> s(scratch);
  using S = typename SortVal<V>::type;
  static_assert(sizeof(S) == sizeof(V), "the sort reuses the value buffers");
  S sv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sv[e] = SortVal<V>::to(r.val[e]);
  bitonic_sort<S, W, 2, 1>(r.key, sv, t,
                           reinterpret_cast<unsigned char*>(s.key),
                           reinterpret_cast<S*>(s.val), s.p);
#pragma unroll
  for (int e = 0; e < E; ++e) r.val[e] = SortVal<V>::from(sv[e]);

  // a wide row publishes its sorted keys and values in buffer s.p for the
  // tails and the run-sum
  int* skey = s.key + s.p * W;
  if constexpr (Geom<W>::kWide) {
    V* sval = s.val + s.p * W;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      skey[e * T + t] = r.key[e];
      sval[e * T + t] = r.val[e];
    }
    __syncthreads();
  }

  // run tails, and the tails up to each lane within the thread
  int next_key;  // lane t*E + E's key (thread t+1's first)
  if constexpr (Geom<W>::kWide) {
    next_key = skey[t + 1 < T ? t + 1 : t];
  } else if constexpr (T > 1) {
    next_key = __shfl_down_sync(kFullMask, r.key[0], 1, T);
  } else {
    next_key = sentinel;
  }
  int own = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool last = e == E - 1 && t == T - 1;  // lane W - 1
    const int next = e < E - 1 ? r.key[e + 1] : next_key;
    r.tail[e] = r.key[e] < sentinel && (last || r.key[e] != next);
    own += r.tail[e];
    r.incl[e] = own;
  }
  // inclusive scan of the threads' counts over the warp (or the row's part)
  constexpr int kSpan = T < kWarp ? T : kWarp;
  const int lane = t % kSpan;
  int scan = own;
#pragma unroll
  for (int k = 1; k < kSpan; k <<= 1) {
    const int up = __shfl_up_sync(kFullMask, scan, k, kSpan);
    if (lane >= k) scan += up;
  }
  if constexpr (Geom<W>::kWide) {
    if (lane == kWarp - 1) s.warp_tails[t / kWarp] = scan;
  }

  runsum_step<V, W, 1>(r, t, s, skey);

  int before = scan - own;  // tails in the row before this thread
  if constexpr (Geom<W>::kWide) {
    // written before the run-sum's barriers, so visible now
#pragma unroll
    for (int w = 0; w < T / kWarp; ++w) {
      if (w < t / kWarp) before += s.warp_tails[w];
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) r.incl[e] += before;
}

// E consecutive lanes from or to device memory; 16-byte (or E-lane) vectors
// when `vec` says every pointer is 16-byte aligned.
template <typename X, int N>
struct alignas(sizeof(X) * N) Pack {
  X v[N];
};

template <typename X, int E>
__host__ __device__ constexpr int pack_lanes() {
  return E * static_cast<int>(sizeof(X)) >= 16 ? 16 / static_cast<int>(sizeof(X))
                                               : E;
}

template <typename X, int E>
__device__ __forceinline__ void load_lanes(X (&r)[E], const X* src, bool vec) {
  constexpr int N = pack_lanes<X, E>();
  if (vec) {
#pragma unroll
    for (int c = 0; c < E / N; ++c) {
      const Pack<X, N> p = reinterpret_cast<const Pack<X, N>*>(src)[c];
#pragma unroll
      for (int j = 0; j < N; ++j) r[c * N + j] = p.v[j];
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) r[e] = src[e];
  }
}

template <typename X, int E>
__device__ __forceinline__ void store_lanes(X* dst, const X (&r)[E], bool vec) {
  constexpr int N = pack_lanes<X, E>();
  if (vec) {
#pragma unroll
    for (int c = 0; c < E / N; ++c) {
      Pack<X, N> p;
#pragma unroll
      for (int j = 0; j < N; ++j) p.v[j] = r[c * N + j];
      reinterpret_cast<Pack<X, N>*>(dst)[c] = p;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = r[e];
  }
}

// Whether every pointer is 16-byte aligned (the rows' offsets keep it).
template <typename... P>
inline bool aligned16(const P*... p) {
  return ((reinterpret_cast<unsigned long long>(p) % 16 == 0) && ...);
}

}  // namespace sort_merge
