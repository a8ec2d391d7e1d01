// mfb_pool: the MFB sum-pool, signed square root and row L2 normalisation.
//
//   z [n, k*m] (bf16 or float32) -> out [n, m] (z's dtype)
//   pooled[d] = sum_j z[j*m + d]        (STRIDED groups: the checkpoint contract)
//   ss[d]     = sign(pooled[d]) * sqrt(|pooled[d]| + 1e-12)
//   out[d]    = ss[d] * rsqrt(sum_d ss[d]^2 + 1e-12)
//
// Replaces vqa_tpu/ops/mfb_pool.py::_mfb_pool_pallas (_pallas_fwd, _kernel).
// It follows the Pallas kernel's numerics: the pool, the roots and the norm
// in fp32, the output rounded once to z's dtype (bf16; float32 stores the
// fp32 values as they are), but for the float32 entry's pool, summed in
// fp64 and rounded once (see Acc). The element type is a template parameter: one
// entry a dtype (vqa_mfb_pool, vqa_mfb_pool_f32), the same kernel.
//
// What bounds it on the H100: memory. At the MFB attention call (B=1024
// questions x 36 regions = 36,864 rows, k=5, m=1000) it reads 369 MB and
// writes 74 MB for ~10 FLOP per output element; the floor is 443 MB over the
// card's 3.35 TB/s, ~0.13 ms (predicted before the first run). In float32
// twice the bytes: ~0.26 ms.
//
// What the design does about it: one 128-thread block per row, so any row
// count works and the whole reduction stays in the block. Two designs by m
// (ops/mfb_pool.py::mfb_plan): "shared" keeps the roots in shared memory,
// opted in past the default 48 KB up to what a block may (m <= ~58,000);
// "global", past that, keeps them in the output row (rounded to its type:
// exact in float32, one more bf16 rounding, ~2^-9 of a value of ~m^-1/2, in
// bf16) and scales them in a second sweep over that row. Threads stride over
// the m outputs 8 at a time with 16-byte loads (two in float32) of each of
// the k strided slices (m % 8 == 0 and 16-byte-aligned bases; scalar loads
// otherwise), so every input byte is read once, coalesced. The signed roots
// wait in shared memory as fp32 (m floats, each read back by the thread that
// wrote it) while a warp-shuffle + shared-memory reduction sums their
// squares; then each thread scales its own values and stores them with
// 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// 8 consecutive elements (16-byte aligned) to and from fp32
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  Pack8 q;
  q.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(q.h[e]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&y)[8]) {
  Pack8 q;
#pragma unroll
  for (int e = 0; e < 8; ++e) q.h[e] = __float2bfloat16(y[e]);
  *reinterpret_cast<uint4*>(p) = q.u;
}

__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// sign(p) * sqrt(|p| + 1e-12), with sign(0) = 0 as jnp.sign
__device__ __forceinline__ float signed_sqrt(float p) {
  const float s = static_cast<float>((p > 0.f) - (p < 0.f));
  return s * sqrtf(fabsf(p) + 1e-12f);
}

// the pool's accumulator: fp32 for bf16 inputs (as the Pallas kernel);
// fp64 for float32 ones, so that a pooled value near 0, where the signed
// square root is ill-conditioned, is the float32 rounding of the exact sum.
// Summed in fp32, 37 rows of m = 70,000 (k=5) came 1.05e-4 of the max-abs
// from float64, the plain float32 version 9.4e-6 (NVIDIA H100 80GB HBM3)
template <typename T>
using Acc = std::conditional_t<std::is_same_v<T, float>, double, float>;

template <typename T, bool kVec, bool kRootsInOut>
__global__ void __launch_bounds__(kThreads)
mfb_pool_kernel(const T* __restrict__ z, T* __restrict__ out, int k, int m) {
  extern __shared__ float ss_s[];  // [m] signed roots (the shared design)
  __shared__ float part_s[kWarps];
  const int64_t row = blockIdx.x;
  const T* zr = z + row * k * static_cast<int64_t>(m);
  T* orow = out + row * static_cast<int64_t>(m);

  float sq = 0.f;
  if (kVec) {
    for (int d = threadIdx.x * 8; d < m; d += kThreads * 8) {
      Acc<T> acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int j = 0; j < k; ++j) {
        float x[8];
        load8(zr + static_cast<int64_t>(j) * m + d, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += x[e];
      }
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s = signed_sqrt(static_cast<float>(acc[e]));
        if (!kRootsInOut) ss_s[d + e] = s;
        y[e] = s;
        sq += s * s;
      }
      if (kRootsInOut) store8(orow + d, y);
    }
  } else {
    for (int d = threadIdx.x; d < m; d += kThreads) {
      Acc<T> acc = 0;
      for (int j = 0; j < k; ++j) acc += to_float(zr[static_cast<int64_t>(j) * m + d]);
      const float s = signed_sqrt(static_cast<float>(acc));
      if (kRootsInOut) {
        store1(orow + d, s);
      } else {
        ss_s[d] = s;
      }
      sq += s * s;
    }
  }

  sq = warp_sum(sq);
  if (threadIdx.x % 32 == 0) part_s[threadIdx.x / 32] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part_s[w];
  const float scale = rsqrtf(total + 1e-12f);

  // each thread scales the values it wrote itself (in shared memory, or in
  // its output row): no barrier needed
  if (kVec) {
    for (int d = threadIdx.x * 8; d < m; d += kThreads * 8) {
      float y[8];
      if (kRootsInOut) {
        load8(orow + d, y);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = ss_s[d + e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] *= scale;
      store8(orow + d, y);
    }
  } else {
    for (int d = threadIdx.x; d < m; d += kThreads) {
      store1(orow + d, (kRootsInOut ? to_float(orow[d]) : ss_s[d]) * scale);
    }
  }
}

// the shared design keeps the m roots in shared memory (opted in past the
// default 48 KB); kRootsInOut, past what a block may opt into, in the
// output row
template <typename T, bool kRootsInOut>
int launch(const void* z, void* out, int64_t n, int k, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (k < 1 || n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = kRootsInOut ? 0 : static_cast<size_t>(m) * sizeof(float);
  const bool vec = m % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const T* zp = static_cast<const T*>(z);
  T* op = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(n);
  auto kernel = vec ? mfb_pool_kernel<T, true, kRootsInOut> : mfb_pool_kernel<T, false, kRootsInOut>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(zp, op, k, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One block per row on `stream`, z and out bf16, the roots in m floats of
// shared memory (opted in past 48 KB; the wrapper's plan keeps m within
// what a block may opt into). Returns the launch's cudaError_t, or 0.
extern "C" int vqa_mfb_pool(const void* z, void* out, int64_t n, int k, int m, void* stream) {
  return launch<bf16, false>(z, out, n, k, m, stream);
}

// The same with z and out float32.
extern "C" int vqa_mfb_pool_f32(const void* z, void* out, int64_t n, int k, int m, void* stream) {
  return launch<float, false>(z, out, n, k, m, stream);
}

// The global design, for m past the shared memory a block may opt into: the
// signed roots wait in the output row in device memory (rounded to its type)
// and a second sweep scales them by the row's norm. `elem` 2: bf16, 4:
// float32. Returns the launch's cudaError_t, or 0.
extern "C" int vqa_mfb_pool_global(const void* z, void* out, int64_t n, int k, int m, int elem,
                                   void* stream) {
  if (elem == 2) return launch<bf16, true>(z, out, n, k, m, stream);
  if (elem == 4) return launch<float, true>(z, out, n, k, m, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
