// Exact negacyclic polynomial product for Hopper (sm_90a): C = N(a) . B mod q.
//
// Replaces the TPU kernel src/repro/kernels/polymul/polymul.py::_polymul_kernel
// (negacyclic_matmul_pallas), the ring multiply of the R-LWE KEM (keygen
// a.s, encapsulate a.r and b.r, decapsulate s.c1).  The Pallas body split
// every coefficient into 7-bit limbs so four int8 MXU products stayed exact;
// here each column of B is contracted directly in 64-bit integers, which is
// exact for any q < 2^14 and gives the same bits as every exact method.
//
// Layout.  One CTA per column of B, one thread per output coefficient k.
// The CTA stages a and its column, both centered into (-q/2, q/2], in shared
// memory; thread k then walks j = 0..n-1 over N(a)[k, j] = +-a[(k - j) mod n]
// (sign - where k < j), so the n x n matrix is never built in device memory.
//
// Bound.  The KEM calls this with one column per call (B = 1 per
// encapsulation or decapsulation), so the work (2 n^2 = 131k integer
// operations, 3 KiB of traffic at n = 256) is far below a microsecond of
// either roof: the kernel is bound by launch latency.  Batching the S
// encapsulations of a stripe into one launch is what would move it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int32_t center(int32_t x, int32_t q) {
  x %= q;
  if (x < 0) x += q;
  return x > q / 2 ? x - q : x;
}

// a: (n,) int32; vecs: (B, n) int32; out: (B, n) int32 in [0, q).
__global__ void negacyclic_kernel(const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ vecs,
                                  int32_t* __restrict__ out, int n, int q) {
  extern __shared__ int32_t smem[];
  int32_t* ac = smem;      // centered a
  int32_t* vc = smem + n;  // centered column
  const int col = blockIdx.x;
  const int k = threadIdx.x;
  ac[k] = center(a[k], q);
  vc[k] = center(vecs[static_cast<int64_t>(col) * n + k], q);
  __syncthreads();
  int64_t acc = 0;
  for (int j = 0; j <= k; ++j) acc += static_cast<int64_t>(ac[k - j]) * vc[j];
  for (int j = k + 1; j < n; ++j) acc -= static_cast<int64_t>(ac[n + k - j]) * vc[j];
  int64_t r = acc % q;
  if (r < 0) r += q;
  out[static_cast<int64_t>(col) * n + k] = static_cast<int32_t>(r);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError().  n <= 1024 (one thread
// per coefficient); the caller checks shapes, types and contiguity.
extern "C" int negacyclic_launch(const void* a, const void* vecs, void* out,
                                 int n, int batch, int q, void* stream) {
  if (batch <= 0) return cudaGetLastError();
  negacyclic_kernel<<<batch, n, 2 * n * sizeof(int32_t),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(vecs),
      static_cast<int32_t*>(out), n, q);
  return static_cast<int>(cudaGetLastError());
}
