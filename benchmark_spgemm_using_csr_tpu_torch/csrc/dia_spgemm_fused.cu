// K3 — dia_spgemm_fused for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmark_spgemm_using_csr_tpu/ops/dia_pallas.py
// ::dia_spgemm_fused (Pallas kernel _dia_kernel): C = A @ B on diagonal
// planes,
//     C[p][j] = sum over the terms (s1, s2, d2) of output plane p of
//               A[s1][j - d2] * B[s2][j],
// where A is (nd_a, k), B is (nd_b, n), C is (nd_c, n), all row-major, and
// A reads outside [0, k) are 0 (this replaces the reference's zero-padded
// copy of A). The term table is a CSR over the output planes: plane p owns
// terms [plane_ptr[p], plane_ptr[p + 1]), each an int32 triple (s1, s2, d2),
// in ascending s2, the order of both reference forms.
//
// Design: one thread owns one C[p][j]; a block covers 256 columns of one
// plane (grid x = column blocks, grid y = planes, looping when there are
// more than 65535). The sum starts from the first term and adds the others
// in table order with __fmul_rn / __fadd_rn (__dmul_rn / __dadd_rn), so
// nvcc cannot contract a multiply-add into an FMA: the result equals the
// plain PyTorch version (a multiply, then an add, each rounded) bit for bit.
// Offsets into the planes are 64-bit (p * n + j passes 2^31 on the larger
// shapes).
//
// What bounds it on the H100: the least traffic is each plane read or
// written once, (nd_a + nd_b + nd_c) * n * sizeof(T) bytes; the arithmetic
// is 2 * terms * n flops, far below the fp32 rate. This first form reads
// A and B once per term through L1/L2 instead of staging a column block of
// every plane in shared memory (the Pallas kernel's VMEM residency); that
// redesign is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGridY = 65535;

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

template <typename T>
__global__ void __launch_bounds__(kBlock) dia_spgemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    const int* __restrict__ plane_ptr, const int* __restrict__ terms,
    int nd_c, long long k, long long n) {
  const long long j = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (j >= n) return;
  for (int p = blockIdx.y; p < nd_c; p += gridDim.y) {
    const int t0 = plane_ptr[p];
    const int t1 = plane_ptr[p + 1];
    T acc = T(0);
    for (int t = t0; t < t1; ++t) {
      const int s1 = terms[3 * t];
      const int s2 = terms[3 * t + 1];
      const long long ja = j - terms[3 * t + 2];
      const T av = (ja >= 0 && ja < k) ? a[s1 * k + ja] : T(0);
      const T prod = mul_rn(av, b[s2 * n + j]);
      acc = (t == t0) ? prod : add_rn(acc, prod);
    }
    c[p * n + j] = acc;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, const void* plane_ptr,
           const void* terms, int nd_c, long long k, long long n,
           cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(nd_c < kMaxGridY ? nd_c : kMaxGridY));
  dia_spgemm_kernel<T><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(plane_ptr), static_cast<const int*>(terms),
      nd_c, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates every buffer: a (nd_a, k), b (nd_b, n) and c (nd_c, n) of float
// (is_double == 0) or double, plane_ptr (nd_c + 1,) and terms (T, 3) int32,
// all contiguous on one device; every plane has at least one term.
extern "C" int dia_spgemm_fused_launch(const void* a, const void* b, void* c,
                                       const void* plane_ptr,
                                       const void* terms, int nd_c,
                                       long long k, long long n,
                                       int is_double, void* stream) {
  if (nd_c < 0 || k < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nd_c == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(a, b, c, plane_ptr, terms, nd_c, k, n, s)
                   : launch<float>(a, b, c, plane_ptr, terms, nd_c, k, n, s);
}
