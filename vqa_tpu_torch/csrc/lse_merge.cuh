// lse_merge.cuh: the merge of softmax-weighted sums taken over chunks of the
// softmax axis, by their log-sum-exp. Shared by relation.cu's split design
// (chunks of r's rows) and glimpse_head.cu's split design (chunks of the
// regions).
//
//   part  [rows, C, D] fp32: o_c = sum_{j in chunk c} exp(s_j - m_c) x_j
//   stats [rows, C, 2] fp32: (m_c, l_c), m_c the chunk's max of s and
//                            l_c = sum_{j in chunk c} exp(s_j - m_c)
//   out   [rows, D]:         sum_c e^{m_c - m} o_c / sum_c e^{m_c - m} l_c,
//                            m = max_c m_c, rounded once to out's type
//
// One block a row: each chunk's weight e^{m_c - m} once into shared memory
// (C floats), the denominator summed by every thread in chunk order (all
// threads hold the same value), then a thread a column summing its C
// partials in chunk order (coalesced fp32 loads; no atomics, so two calls
// give the same bits). A chunk whose scores are all the same (MFB's masked
// rows, finfo.min) has m_c = that value and l_c = its length, so a row
// masked whole keeps uniform weights, as the unsplit softmax does. The
// merge reads C D + 2 C floats and writes D values a row: bound by bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lse {

constexpr int kMergeThreads = 256;
constexpr int kMaxMergeChunks = 48 * 1024 / 4;  // the weights in default shared memory

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part, const float* __restrict__ stats, T* __restrict__ out,
             int C, int D) {
  extern __shared__ float w_s[];  // [C] each chunk's weight e^{m_c - m}
  const int64_t row = blockIdx.x;
  const float* st = stats + row * C * 2;
  float m = __int_as_float(0xff800000);  // -inf
  for (int c = 0; c < C; ++c) m = fmaxf(m, st[2 * c]);
  for (int c = threadIdx.x; c < C; c += kMergeThreads) w_s[c] = expf(st[2 * c] - m);
  __syncthreads();
  float den = 0.f;
  for (int c = 0; c < C; ++c) den += w_s[c] * st[2 * c + 1];
  const float inv = 1.f / den;
  const float* pr = part + row * C * static_cast<int64_t>(D);
  T* orow = out + row * static_cast<int64_t>(D);
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += w_s[c] * pr[static_cast<int64_t>(c) * D + d];
    store(orow + d, acc * inv);
  }
}

// one launch of the merge over `rows` rows on `s`; cudaErrorInvalidValue
// past the chunks its shared memory holds
template <typename T>
cudaError_t merge(const float* part, const float* stats, T* out, int64_t rows, int C, int D,
                  cudaStream_t s) {
  if (rows <= 0) return cudaSuccess;
  if (C < 1 || C > kMaxMergeChunks || D < 1 || rows >= (1LL << 31)) return cudaErrorInvalidValue;
  merge_kernel<T><<<static_cast<unsigned>(rows), kMergeThreads, C * sizeof(float), s>>>(
      part, stats, out, C, D);
  return cudaGetLastError();
}

}  // namespace lse
