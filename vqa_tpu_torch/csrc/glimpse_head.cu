// glimpse_head: the fused tail of question-conditioned glimpse attention.
//
//   joint [B, R, M], w [M, G], b [G], v [B, R, D] (bf16)
//   logits[b, r, g]   = sum_m joint[b, r, m] * w[m, g] + b[g]
//   alpha[b, :, g]    = softmax over the R regions of logits[b, :, g]
//   attended[b, g, d] = sum_r alpha[b, r, g] * v[b, r, d]
//   -> attended [B, G, D] (v's dtype), logits [B, R, G] (joint's dtype)
//
// Replaces vqa_tpu/ops/attention.py::_glimpse_head_pallas (_head_pallas,
// _head_kernel). It follows the Pallas kernel's numerics: logits and softmax
// in fp32, alpha rounded to v's dtype before the weighted sum, which
// accumulates in fp32.
//
// What bounds it on the H100: memory. Per batch row it reads joint once
// (36 x 510 bf16, 37 KB) and v once (36 x 2048 bf16, 147 KB) for ~0.4 MFLOP,
// ~189 MB at B=1024, far below the card's ~295 FLOP/byte balance point.
//
// What the design does about it: one block per batch row, so the logits and
// alpha never leave shared memory and each input byte is read exactly once.
// The R x G logits are fp32 dot products over M: each warp takes regions,
// its lanes stride over M reading joint coalesced and accumulating all G
// glimpses at once, then a warp shuffle reduction. The softmax over R (36
// values per glimpse) runs in one thread per glimpse. The weighted sum then
// strides the threads over D with 16-byte loads of v (8 bf16), each thread
// keeping G x 8 fp32 accumulators across the R regions, and writes 16-byte
// stores. D % 8 != 0 takes scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxG = 4;

union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
glimpse_head_kernel(const bf16* __restrict__ joint, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const bf16* __restrict__ v,
                    bf16* __restrict__ out, bf16* __restrict__ logits_out, int R, int M,
                    int G, int D) {
  extern __shared__ float smem[];
  float* w_s = smem;              // [M, G]
  float* alpha_s = smem + M * G;  // [R, G]: logits, then alpha
  const int64_t b = blockIdx.x;
  const bf16* jb = joint + b * R * M;
  const bf16* vb = v + b * R * D;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kWarps = kThreads / 32;

  for (int i = threadIdx.x; i < M * G; i += kThreads) w_s[i] = __bfloat162float(w[i]);
  __syncthreads();

  // logits: one warp per region
  for (int r = warp; r < R; r += kWarps) {
    float acc[kMaxG] = {0.f, 0.f, 0.f, 0.f};
    const bf16* row = jb + static_cast<int64_t>(r) * M;
    for (int m = lane; m < M; m += 32) {
      const float x = __bfloat162float(row[m]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) acc[g] += x * w_s[m * G + g];
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float l = warp_sum(acc[g]) + __bfloat162float(bias[g]);
        if (lane == 0) {
          alpha_s[r * G + g] = l;
          logits_out[(b * R + r) * G + g] = __float2bfloat16(l);
        }
      }
    }
  }
  __syncthreads();

  // softmax over the regions, one thread per glimpse
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int r = 0; r < R; ++r) mx = fmaxf(mx, alpha_s[r * G + g]);
    float sum = 0.f;
    for (int r = 0; r < R; ++r) {
      const float e = expf(alpha_s[r * G + g] - mx);
      alpha_s[r * G + g] = e;
      sum += e;
    }
    const float inv = 1.f / sum;
    for (int r = 0; r < R; ++r) {
      alpha_s[r * G + g] = __bfloat162float(__float2bfloat16(alpha_s[r * G + g] * inv));
    }
  }
  __syncthreads();

  // attended[g, d] = sum_r alpha[r, g] * v[r, d]
  bf16* ob = out + b * G * D;
  if (kVec) {
    for (int d = threadIdx.x * 8; d < D; d += kThreads * 8) {
      float acc[kMaxG][8];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[g][k] = 0.f;
      for (int r = 0; r < R; ++r) {
        Pack8 x;
        x.u = *reinterpret_cast<const uint4*>(vb + static_cast<int64_t>(r) * D + d);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float a = alpha_s[r * G + g];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[g][k] += a * __bfloat162float(x.h[k]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          Pack8 y;
#pragma unroll
          for (int k = 0; k < 8; ++k) y.h[k] = __float2bfloat16(acc[g][k]);
          *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(g) * D + d) = y.u;
        }
      }
    }
  } else {
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc[kMaxG] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < R; ++r) {
        const float x = __bfloat162float(vb[static_cast<int64_t>(r) * D + d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) acc[g] += alpha_s[r * G + g] * x;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) ob[static_cast<int64_t>(g) * D + d] = __float2bfloat16(acc[g]);
      }
    }
  }
}

}  // namespace

// One block per batch row on `stream`. Needs G <= 4 and (M + R) * G floats of
// shared memory (checked by the Python wrapper). Returns the launch's
// cudaError_t, or 0.
extern "C" int vqa_glimpse_head(const void* joint, const void* w, const void* bias,
                                const void* v, void* out, void* logits, int B, int R, int M,
                                int G, int D, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(M + R) * G * sizeof(float);
  const bool vec = D % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const bf16* jp = static_cast<const bf16*>(joint);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* bp = static_cast<const bf16*>(bias);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(out);
  bf16* lp = static_cast<bf16*>(logits);
  if (vec) {
    glimpse_head_kernel<true><<<B, kThreads, smem, s>>>(jp, wp, bp, vp, op, lp, R, M, G, D);
  } else {
    glimpse_head_kernel<false><<<B, kThreads, smem, s>>>(jp, wp, bp, vp, op, lp, R, M, G, D);
  }
  return static_cast<int>(cudaGetLastError());
}
