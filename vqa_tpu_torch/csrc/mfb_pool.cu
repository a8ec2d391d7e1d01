// mfb_pool: the MFB sum-pool, signed square root and row L2 normalisation.
//
//   z [n, k*m] (bf16) -> out [n, m] (bf16)
//   pooled[d] = sum_j z[j*m + d]        (STRIDED groups: the checkpoint contract)
//   ss[d]     = sign(pooled[d]) * sqrt(|pooled[d]| + 1e-12)
//   out[d]    = ss[d] * rsqrt(sum_d ss[d]^2 + 1e-12)
//
// Replaces vqa_tpu/ops/mfb_pool.py::_mfb_pool_pallas (_pallas_fwd, _kernel).
// It follows the Pallas kernel's numerics: the pool, the roots and the norm
// in fp32, the output rounded once to bf16.
//
// What bounds it on the H100: memory. At the MFB attention call (B=1024
// questions x 36 regions = 36,864 rows, k=5, m=1000) it reads 369 MB and
// writes 74 MB for ~10 FLOP per output element; the floor is 443 MB over the
// card's 3.35 TB/s, ~0.13 ms (predicted before the first run).
//
// What the design does about it: one 128-thread block per row, so any row
// count works and the whole reduction stays in the block. Threads stride over
// the m outputs 8 at a time with 16-byte loads of each of the k strided
// slices (m % 8 == 0 and 16-byte-aligned bases; scalar loads otherwise), so
// every input byte is read once, coalesced. The signed roots wait in shared
// memory as fp32 (m floats, each read back by the thread that wrote it)
// while a warp-shuffle + shared-memory reduction sums their squares; then
// each thread scales its own values and stores them with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

union Pack8 {
  uint4 u;
  bf16 h[8];
};

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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mfb_pool_kernel(const bf16* __restrict__ z, bf16* __restrict__ out, int k, int m) {
  extern __shared__ float ss_s[];  // [m] signed roots
  __shared__ float part_s[kWarps];
  const int64_t row = blockIdx.x;
  const bf16* zr = z + row * k * static_cast<int64_t>(m);
  bf16* orow = out + row * static_cast<int64_t>(m);

  float sq = 0.f;
  if (kVec) {
    for (int d = threadIdx.x * 8; d < m; d += kThreads * 8) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        Pack8 x;
        x.u = *reinterpret_cast<const uint4*>(zr + static_cast<int64_t>(j) * m + d);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += __bfloat162float(x.h[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s = signed_sqrt(acc[e]);
        ss_s[d + e] = s;
        sq += s * s;
      }
    }
  } else {
    for (int d = threadIdx.x; d < m; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j) acc += __bfloat162float(zr[static_cast<int64_t>(j) * m + d]);
      const float s = signed_sqrt(acc);
      ss_s[d] = s;
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

  // each thread scales the values it wrote itself: no barrier needed on ss_s
  if (kVec) {
    for (int d = threadIdx.x * 8; d < m; d += kThreads * 8) {
      Pack8 y;
#pragma unroll
      for (int e = 0; e < 8; ++e) y.h[e] = __float2bfloat16(ss_s[d + e] * scale);
      *reinterpret_cast<uint4*>(orow + d) = y.u;
    }
  } else {
    for (int d = threadIdx.x; d < m; d += kThreads) orow[d] = __float2bfloat16(ss_s[d] * scale);
  }
}

}  // namespace

// One block per row on `stream`. Needs m floats of shared memory (at most
// 48 KB, checked by the Python wrapper). Returns the launch's cudaError_t,
// or 0.
extern "C" int vqa_mfb_pool(const void* z, void* out, int64_t n, int k, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  const bool vec = m % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const bf16* zp = static_cast<const bf16*>(z);
  bf16* op = static_cast<bf16*>(out);
  const unsigned grid = static_cast<unsigned>(n);
  if (vec) {
    mfb_pool_kernel<true><<<grid, kThreads, smem, s>>>(zp, op, k, m);
  } else {
    mfb_pool_kernel<false><<<grid, kThreads, smem, s>>>(zp, op, k, m);
  }
  return static_cast<int>(cudaGetLastError());
}
