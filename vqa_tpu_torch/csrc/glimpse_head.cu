// glimpse_head / glimpse_attend: the fused tail of glimpse attention.
//
//   glimpse_head: joint [B, R, M], w [M, G], b [G], v [B, R, D] (bf16)
//     logits[b, r, g]   = sum_m joint[b, r, m] * w[m, g] + b[g]
//     -> attended [B, G, D] (v's dtype), logits [B, R, G] (joint's dtype)
//   glimpse_attend: logits [B, R, G] given, v [B, R, D] (bf16)
//     -> attended [B, G, D]
//   both: alpha[b, :, g]    = softmax over the R regions of logits[b, :, g]
//         attended[b, g, d] = sum_r alpha[b, r, g] * v[b, r, d]
//
// Replaces vqa_tpu/ops/attention.py::_glimpse_head_pallas (_head_pallas,
// _head_kernel) and, as the logits-given entry of the same kernel,
// vqa_tpu/ops/attention.py::_glimpse_attend_pallas (_pallas_fwd, _kernel).
// It follows the Pallas kernels' numerics: logits and softmax in fp32,
// alpha rounded to v's dtype before the weighted sum, which accumulates in
// fp32. The softmax subtracts the row's max in fp32, so a row whose logits
// are all the mask value finfo(bf16).min (an all-padding question in MFB's
// self-attention) gives uniform alpha, as jax.nn.softmax does, not nan.
//
// What bounds it on the H100: memory. glimpse_head, per batch row, reads
// joint once (36 x 510 bf16, 37 KB) and v once (36 x 2048 bf16, 147 KB) for
// ~0.4 MFLOP, ~189 MB at B=1024, far below the card's ~295 FLOP/byte balance
// point. glimpse_attend at MFB's question self-attention (B=1024, T <= 26,
// G=2, D=1024) reads at most 54.5 MB of v and writes 4 MB: its floor is
// ~0.018 ms at T=26 (predicted before the first run).
//
// What the design does about it: one block per batch row, so the logits and
// alpha never leave shared memory and each input byte is read exactly once.
// glimpse_head computes the R x G logits as fp32 dot products over M: each
// warp takes regions, its lanes stride over M reading joint coalesced and
// accumulating all G glimpses at once, then a warp shuffle reduction;
// glimpse_attend reads the given logits instead (template kLogitsGiven, with
// R x G floats of shared memory). The softmax over R (36 values per glimpse)
// runs in one thread per glimpse. The weighted sum then strides the threads
// over D with 16-byte loads of v (8 bf16), each thread keeping G x 8 fp32
// accumulators across the R regions, and writes 16-byte stores. D % 8 != 0
// takes scalar loads.

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

// logits[r, g] = joint[r, :] . w[:, g] + bias[g] into alpha_s (fp32) and
// logits_out (bf16): w staged in shared memory, one warp per region
__device__ __forceinline__ void compute_logits(const bf16* __restrict__ jb,
                                               const bf16* __restrict__ w,
                                               const bf16* __restrict__ bias, float* w_s,
                                               float* alpha_s, bf16* __restrict__ logits_out,
                                               int R, int M, int G) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kWarps = kThreads / 32;
  for (int i = threadIdx.x; i < M * G; i += kThreads) w_s[i] = __bfloat162float(w[i]);
  __syncthreads();
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
          logits_out[r * G + g] = __float2bfloat16(l);
        }
      }
    }
  }
}

// kLogitsGiven: read logits [B, R, G] (glimpse_attend) instead of computing
// them from joint, w and bias (glimpse_head, which also writes logits_out)
template <bool kVec, bool kLogitsGiven>
__global__ void __launch_bounds__(kThreads)
glimpse_head_kernel(const bf16* __restrict__ joint, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const bf16* __restrict__ logits_in,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    bf16* __restrict__ logits_out, int R, int M, int G, int D) {
  extern __shared__ float smem[];
  float* w_s = smem;                                   // [M, G] (glimpse_head only)
  float* alpha_s = smem + (kLogitsGiven ? 0 : M * G);  // [R, G]: logits, then alpha
  const int64_t b = blockIdx.x;
  const bf16* vb = v + b * R * D;

  if (kLogitsGiven) {
    const bf16* lb = logits_in + b * R * G;
    for (int i = threadIdx.x; i < R * G; i += kThreads) alpha_s[i] = __bfloat162float(lb[i]);
  } else {
    compute_logits(joint + b * R * M, w, bias, w_s, alpha_s, logits_out + b * R * G, R, M, G);
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

template <bool kLogitsGiven>
cudaError_t launch(const void* joint, const void* w, const void* bias, const void* logits_in,
                   const void* v, void* out, void* logits_out, int B, int R, int M, int G, int D,
                   size_t smem, cudaStream_t s) {
  const bool vec = D % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto* jp = static_cast<const bf16*>(joint);
  auto* wp = static_cast<const bf16*>(w);
  auto* bp = static_cast<const bf16*>(bias);
  auto* li = static_cast<const bf16*>(logits_in);
  auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  auto* lo = static_cast<bf16*>(logits_out);
  if (vec) {
    glimpse_head_kernel<true, kLogitsGiven>
        <<<B, kThreads, smem, s>>>(jp, wp, bp, li, vp, op, lo, R, M, G, D);
  } else {
    glimpse_head_kernel<false, kLogitsGiven>
        <<<B, kThreads, smem, s>>>(jp, wp, bp, li, vp, op, lo, R, M, G, D);
  }
  return cudaGetLastError();
}

}  // namespace

// glimpse_head: one block per batch row on `stream`. Needs G <= 4 and
// (M + R) * G floats of shared memory (checked by the Python wrapper).
// Returns the launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_head(const void* joint, const void* w, const void* bias,
                                const void* v, void* out, void* logits, int B, int R, int M,
                                int G, int D, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(M + R) * G * sizeof(float);
  return static_cast<int>(launch<false>(joint, w, bias, nullptr, v, out, logits, B, R, M, G, D,
                                        smem, static_cast<cudaStream_t>(stream)));
}

// glimpse_attend, the logits-given entry: one block per batch row on
// `stream`. Needs G <= 4 and R * G floats of shared memory (checked by the
// Python wrapper). Returns the launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_attend(const void* logits, const void* v, void* out, int B, int R,
                                  int G, int D, void* stream) {
  if (B <= 0) return 0;
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(R) * G * sizeof(float);
  return static_cast<int>(launch<true>(nullptr, nullptr, nullptr, logits, v, out, nullptr, B, R,
                                       0, G, D, smem, static_cast<cudaStream_t>(stream)));
}
