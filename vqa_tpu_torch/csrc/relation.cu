// relation_attend: the CoR relation core.
//
//   pg [B, N, D], r [B, N, D] (bf16)
//   s[b, i, j]     = sum_d pg[b, i, d] * r[b, j, d] / sqrt(D)
//   alpha[b, i, :] = softmax over j of s[b, i, :]
//   out[b, i, d]   = sum_j alpha[b, i, j] * r[b, j, d]       -> out [B, N, D] (bf16)
//
// Replaces vqa_tpu/ops/relation.py::_relation_attend_pallas (_pallas_fwd,
// _kernel). It follows the Pallas kernel's numerics: scores, softmax and the
// weighted sum in fp32; alpha is NOT rounded to bf16 before the second
// product (unlike glimpse_head); only the output is rounded.
//
// What bounds it on the H100: at the CoR shapes (B=1024, N=36, D=1024) it
// reads 151 MB and writes 75 MB, 0.068 ms at 3.35 TB/s, and does 2 x 1.36
// GFMA: the second product on the fp32 CUDA cores (67 TFLOP/s) takes at
// least 0.041 ms, the first on the tensor cores next to nothing. Predicted
// before the first run of this design (scores on the tensor cores): ~0.1
// ms, memory and the fp32 product overlapping across the two blocks an SM
// holds. Measured on an H100 80GB HBM3 at 700 W: 0.22-0.25 ms, level with
// the plain cuBLAS chain. The kernel moves its 226 MB at ~1 TB/s: the copy
// of r alone runs at ~1.6 TB/s, and the phases of a block (copy, scores,
// weighted sum) run one after another. Prefetching the next element's rows
// (TMA bulk copies, a persistent grid) is the next step.
//
// What the design does about it: one block per batch element, so s never
// leaves the SM. r[b] is copied into shared memory (opted in above 48 KB),
// its rows padded by 16 bytes so that eight rows read at one column hit
// eight different bank groups, with s and alpha^T (fp32) beside it: ~85 KB
// at the CoR shape, so two blocks fit on an SM and one block's loads
// overlap the other's math. Scores run on the tensor cores: mma.sync
// m16n8k16 with bf16 operands and fp32 accumulation, which multiplies bf16
// values exactly, as the fp32 dot products of the Pallas kernel do. A warp
// owns one 16-row tile and up to three 8-column tiles of s over all of D,
// so it stores its sums directly, with no reduction between warps; it reads
// its pg fragments straight from device memory (32-bit loads; at N=36 each
// 16-row tile is read by two warps, the second time mostly from L1) and its
// r fragments from shared memory. N is padded to the tiles (N <= 64). The
// softmax over j runs one warp per row in fp32 and stores alpha transposed,
// zero-padded to whole row groups. The weighted sum keeps alpha in fp32 on
// the CUDA cores: each thread owns kOutRows rows x 8 columns of the output,
// and per j one 16-byte load of r[j] and three 8-byte loads of alpha feed
// 48 fma with no branch; it writes 16-byte stores. D % 8 != 0 takes scalar
// loads.
//
// N > 64 (CoR over the extract CLI's 196-region grid) takes a second entry,
// vqa_relation_attend_tiled, with the same numerics: one block per (batch
// element, 16-row tile of i). The tile's pg rows go to shared memory; one
// warp per column j computes that column's 16 scores in fp32 (lanes over
// D, 16-byte loads of r[j] from L2, a shuffle reduction), into shared
// memory as s^T [N, 16] (16 N floats: 12.5 KB at N=196); the softmax runs
// one warp per row in fp32 and leaves alpha^T in place; the weighted sum
// streams r again, each thread owning 4 columns of the 16 output rows (64
// fp32 accumulators) with alpha read as four float4. It reads r once per
// tile from L2 twice over: simple and right, not fast (it is the next
// design's to fix). Its only limit is shared memory: 32 D + 64 N bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;    // objects: at most 4 x 16-row and 8 x 8-column tiles of s
constexpr int kNTPerWarp = 3;  // 8-column tiles of s per warp
constexpr int kOutRows = 6;  // output rows per thread item (even: alpha read as float2)
constexpr int kPad = 8;      // bf16 elements of padding per shared row of r

union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared memory of one block: r padded, s and alpha^T
size_t smem_bytes(int N, int D) {
  return align16(static_cast<size_t>(N) * (D + kPad) * 2) +
         static_cast<size_t>(round_up(N * N, 4) + N * round_up(N, kOutRows)) * sizeof(float);
}

// row[k], row[k + 1] packed into one register (k in the low half), zero past D
template <bool kVec>
__device__ __forceinline__ uint32_t load_pair(const bf16* row, int k, int D) {
  if (kVec) {  // D % 8 == 0 and k even: k < D implies k + 1 < D, 4-byte aligned
    return k < D ? *reinterpret_cast<const uint32_t*>(row + k) : 0u;
  }
  const uint32_t lo = k < D ? __bfloat16_as_ushort(row[k]) : 0u;
  const uint32_t hi = k + 1 < D ? __bfloat16_as_ushort(row[k + 1]) : 0u;
  return lo | (hi << 16);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
relation_kernel(const bf16* __restrict__ pg, const bf16* __restrict__ r, bf16* __restrict__ out,
                int N, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + kPad;                     // shared row stride of r
  const int n_pad = round_up(N, kOutRows);     // rows of alpha, zero past N
  bf16* r_s = reinterpret_cast<bf16*>(smem);   // [N, ld]
  float* s_s = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(N) * ld * 2));
  float* a_s = s_s + round_up(N * N, 4);       // s [N, N], then alpha^T [N, n_pad]
  const int64_t nd = static_cast<int64_t>(N) * D;
  const bf16* pgb = pg + blockIdx.x * nd;
  const bf16* rb = r + blockIdx.x * nd;
  bf16* ob = out + blockIdx.x * nd;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // r[b] into shared memory
  if (kVec) {
    const int n_col = D / 8;
#pragma unroll 4
    for (int i = tid; i < N * n_col; i += kThreads) {
      const int j = i / n_col, c = (i % n_col) * 8;
      *reinterpret_cast<uint4*>(r_s + j * ld + c) =
          *reinterpret_cast<const uint4*>(rb + static_cast<int64_t>(j) * D + c);
    }
  } else {
    for (int i = tid; i < N * D; i += kThreads) r_s[(i / D) * ld + i % D] = rb[i];
  }
  __syncthreads();

  // s = pg . r^T on the tensor cores. Fragment layout of m16n8k16: lane =
  // 4 * g + t holds A rows g and g + 8 at columns 2t, 2t+1 and 2t+8, 2t+9;
  // B column g at rows 2t, 2t+1 and 2t+8, 2t+9; C rows g and g + 8 at
  // columns 2t, 2t+1. A warp owns one 16-row tile and up to kNTPerWarp
  // 8-column tiles of s over all of D, so it stores its sums directly.
  {
    const int g = lane / 4, t = lane % 4;
    const int n_mt = (N + 15) / 16, n_nt = (N + 7) / 8, n_ks = (D + 15) / 16;
    const int n_ntg = (n_nt + kNTPerWarp - 1) / kNTPerWarp;
    for (int p = warp; p < n_mt * n_ntg; p += kWarps) {
      const int mt = p % n_mt, nt0 = (p / n_mt) * kNTPerWarp;
      const int i0 = mt * 16 + g, i1 = i0 + 8;
      const bf16* pa0 = pgb + static_cast<int64_t>(min(i0, N - 1)) * D;
      const bf16* pa1 = pgb + static_cast<int64_t>(min(i1, N - 1)) * D;
      float acc[kNTPerWarp][4] = {};
#pragma unroll 8  // several k steps' fragment loads in flight at once
      for (int ks = 0; ks < n_ks; ++ks) {
        const int k = ks * 16 + 2 * t;
        uint32_t a[4];
        a[0] = i0 < N ? load_pair<kVec>(pa0, k, D) : 0u;
        a[1] = i1 < N ? load_pair<kVec>(pa1, k, D) : 0u;
        a[2] = i0 < N ? load_pair<kVec>(pa0, k + 8, D) : 0u;
        a[3] = i1 < N ? load_pair<kVec>(pa1, k + 8, D) : 0u;
#pragma unroll
        for (int q = 0; q < kNTPerWarp; ++q) {
          if (nt0 + q < n_nt) {  // uniform across the warp: mma.sync stays convergent
            const int j = (nt0 + q) * 8 + g;
            const bf16* rj = r_s + min(j, N - 1) * ld;
            const uint32_t b0 = j < N ? load_pair<kVec>(rj, k, D) : 0u;
            const uint32_t b1 = j < N ? load_pair<kVec>(rj, k + 8, D) : 0u;
            mma_16816(acc[q], a, b0, b1);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kNTPerWarp; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mt * 16 + g + (e / 2) * 8, j = (nt0 + q) * 8 + 2 * t + e % 2;
          if (i < N && j < N) s_s[i * N + j] = acc[q][e];
        }
      }
    }
  }
  __syncthreads();

  // alpha = softmax_j(s / sqrt(D)) in fp32, one warp per row (N <= 64),
  // stored transposed, alpha^T[j, i], with zero rows i in [N, n_pad)
  const float scale = rsqrtf(static_cast<float>(D));
  const float neg_inf = __int_as_float(0xff800000);
  for (int i = warp; i < n_pad; i += kWarps) {
    const float* row = s_s + min(i, N - 1) * N;
    const float v0 = lane < N ? row[lane] * scale : neg_inf;
    const float v1 = lane + 32 < N ? row[lane + 32] * scale : neg_inf;
    const float mx = warp_max(fmaxf(v0, v1));
    const float e0 = lane < N ? expf(v0 - mx) : 0.f;
    const float e1 = lane + 32 < N ? expf(v1 - mx) : 0.f;
    const float inv = i < N ? 1.f / warp_sum(e0 + e1) : 0.f;
    if (lane < N) a_s[lane * n_pad + i] = e0 * inv;
    if (lane + 32 < N) a_s[(lane + 32) * n_pad + i] = e1 * inv;
  }
  __syncthreads();

  // out[i, d..d+W) = sum_j alpha[i, j] * r[j, d..d+W), kOutRows rows a thread
  // item: one 16-byte load of r[j] and three 8-byte loads of alpha^T[j]
  // (the same address across the warp) feed 6 x 8 fma, with no branch
  constexpr int W = kVec ? 8 : 1;
  const int n_col = D / W;
  for (int item = tid; item < (n_pad / kOutRows) * n_col; item += kThreads) {
    const int i0 = (item / n_col) * kOutRows;
    const int d = (item % n_col) * W;
    float acc[kOutRows][W] = {};
#pragma unroll 2
    for (int j = 0; j < N; ++j) {
      float x[W];
      if (kVec) {
        Pack8 p;
        p.u = *reinterpret_cast<const uint4*>(r_s + j * ld + d);
#pragma unroll
        for (int e = 0; e < W; ++e) x[e] = __bfloat162float(p.h[e]);
      } else {
        x[0] = __bfloat162float(r_s[j * ld + d]);
      }
      const float2* al2 = reinterpret_cast<const float2*>(a_s + j * n_pad + i0);
      float al[kOutRows];
#pragma unroll
      for (int q = 0; q < kOutRows / 2; ++q) {
        const float2 v = al2[q];
        al[2 * q] = v.x;
        al[2 * q + 1] = v.y;
      }
#pragma unroll
      for (int rr = 0; rr < kOutRows; ++rr)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[rr][e] += al[rr] * x[e];
    }
#pragma unroll
    for (int rr = 0; rr < kOutRows; ++rr) {
      if (i0 + rr < N) {
        bf16* o = ob + static_cast<int64_t>(i0 + rr) * D + d;
        if (kVec) {
          Pack8 p;
#pragma unroll
          for (int e = 0; e < W; ++e) p.h[e] = __float2bfloat16(acc[rr][e]);
          *reinterpret_cast<uint4*>(o) = p.u;
        } else {
          o[0] = __float2bfloat16(acc[rr][0]);
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const bf16* pg, const bf16* r, bf16* out, int B, int N, int D, size_t smem,
                   cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        relation_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  relation_kernel<kVec><<<B, kThreads, smem, s>>>(pg, r, out, N, D);
  return cudaGetLastError();
}

constexpr int kTileRows = 16;  // rows of i a block of the tiled entry owns

// shared memory of one block of the tiled entry: its pg rows, s^T / alpha^T [N, 16]
size_t tiled_smem_bytes(int N, int D) {
  return align16(static_cast<size_t>(kTileRows) * D * 2) +
         static_cast<size_t>(N) * kTileRows * sizeof(float);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
relation_tiled_kernel(const bf16* __restrict__ pg, const bf16* __restrict__ r,
                      bf16* __restrict__ out, int N, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* pg_s = reinterpret_cast<bf16*>(smem);  // [16, D], zero rows past the tile
  float* a_s = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(kTileRows) * D * 2));
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int64_t b = blockIdx.x / n_tiles;
  const int i0 = (blockIdx.x % n_tiles) * kTileRows;
  const int ni = min(kTileRows, N - i0);
  const int64_t nd = static_cast<int64_t>(N) * D;
  const bf16* pgb = pg + b * nd + static_cast<int64_t>(i0) * D;
  const bf16* rb = r + b * nd;
  bf16* ob = out + b * nd + static_cast<int64_t>(i0) * D;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  if (kVec) {
    const int n_col = D / 8;
    for (int i = tid; i < kTileRows * n_col; i += kThreads) {
      const int row = i / n_col, c = (i % n_col) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < ni) x = *reinterpret_cast<const uint4*>(pgb + static_cast<int64_t>(row) * D + c);
      *reinterpret_cast<uint4*>(pg_s + row * D + c) = x;
    }
  } else {
    for (int i = tid; i < kTileRows * D; i += kThreads) {
      const int row = i / D;
      pg_s[i] = row < ni ? pgb[static_cast<int64_t>(row) * D + i % D] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // s^T[j, i] = <pg_i, r_j>, one warp per column j, all 16 rows at once
  for (int j = warp; j < N; j += kWarps) {
    const bf16* rj = rb + static_cast<int64_t>(j) * D;
    float acc[kTileRows] = {};
    if (kVec) {
#pragma unroll 2
      for (int d = lane * 8; d < D; d += 32 * 8) {
        Pack8 x;
        x.u = *reinterpret_cast<const uint4*>(rj + d);
        float xf[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) xf[e] = __bfloat162float(x.h[e]);
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          Pack8 q;
          q.u = *reinterpret_cast<const uint4*>(pg_s + i * D + d);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i] += __bfloat162float(q.h[e]) * xf[e];
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float x = __bfloat162float(rj[d]);
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) acc[i] += __bfloat162float(pg_s[i * D + d]) * x;
      }
    }
    float mine = 0.f;  // lane i keeps row i's sum (no register array indexed at run time)
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const float t = warp_sum(acc[i]);
      if (lane == i) mine = t;
    }
    if (lane < kTileRows) a_s[j * kTileRows + lane] = mine;
  }
  __syncthreads();

  // alpha = softmax_j(s / sqrt(D)) in fp32, one warp per row, in place
  const float scale = rsqrtf(static_cast<float>(D));
  const float neg_inf = __int_as_float(0xff800000);
  for (int i = warp; i < kTileRows; i += kWarps) {
    float mx = neg_inf;
    for (int j = lane; j < N; j += 32) mx = fmaxf(mx, a_s[j * kTileRows + i] * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) sum += expf(a_s[j * kTileRows + i] * scale - mx);
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < N; j += 32) {
      a_s[j * kTileRows + i] = expf(a_s[j * kTileRows + i] * scale - mx) * inv;
    }
  }
  __syncthreads();

  // out[i, d..d+W) = sum_j alpha[i, j] * r[j, d..d+W) for the 16 rows
  constexpr int W = kVec ? 4 : 1;
  for (int d = tid * W; d < D; d += kThreads * W) {
    float acc[kTileRows][W] = {};
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      float x[W];
      if constexpr (kVec) {
        union {
          uint2 u;
          __nv_bfloat162 h[2];
        } p;
        p.u = *reinterpret_cast<const uint2*>(rb + static_cast<int64_t>(j) * D + d);
        const float2 lo = __bfloat1622float2(p.h[0]), hi = __bfloat1622float2(p.h[1]);
        x[0] = lo.x;
        x[1] = lo.y;
        x[2] = hi.x;
        x[3] = hi.y;
      } else {
        x[0] = __bfloat162float(rb[static_cast<int64_t>(j) * D + d]);
      }
      const float4* al = reinterpret_cast<const float4*>(a_s + j * kTileRows);
#pragma unroll
      for (int q = 0; q < kTileRows / 4; ++q) {
        const float4 a = al[q];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          acc[4 * q][e] += a.x * x[e];
          acc[4 * q + 1][e] += a.y * x[e];
          acc[4 * q + 2][e] += a.z * x[e];
          acc[4 * q + 3][e] += a.w * x[e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      if (i < ni) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ob[static_cast<int64_t>(i) * D + d + e] = __float2bfloat16(acc[i][e]);
        }
      }
    }
  }
}

}  // namespace

// One block per batch element on `stream`. Needs N <= 64 and smem_bytes(N, D)
// of shared memory (at most 227 KB); the Python wrapper checks both.
// Returns the launch's cudaError_t, or 0.
extern "C" int vqa_relation_attend(const void* pg, const void* r, void* out, int B, int N, int D,
                                   void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  if (N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(N, D);
  const bool vec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(pg) | reinterpret_cast<uintptr_t>(r) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto* pp = static_cast<const bf16*>(pg);
  auto* rp = static_cast<const bf16*>(r);
  auto* op = static_cast<bf16*>(out);
  const cudaError_t err = vec ? launch<true>(pp, rp, op, B, N, D, smem, s)
                              : launch<false>(pp, rp, op, B, N, D, smem, s);
  return static_cast<int>(err);
}

// The N > 64 entry: one block per (batch element, 16-row tile of i) on
// `stream`. Needs tiled_smem_bytes(N, D) of shared memory (the Python
// wrapper checks it against the card's opt-in limit). Returns the launch's
// cudaError_t, or 0.
extern "C" int vqa_relation_attend_tiled(const void* pg, const void* r, void* out, int B, int N,
                                         int D, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tiled_smem_bytes(N, D);
  const bool vec = D % 8 == 0 && (reinterpret_cast<uintptr_t>(pg) | reinterpret_cast<uintptr_t>(r) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = vec ? relation_tiled_kernel<true> : relation_tiled_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t grid = static_cast<int64_t>(B) * ((N + kTileRows - 1) / kTileRows);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      static_cast<const bf16*>(pg), static_cast<const bf16*>(r), static_cast<bf16*>(out), N, D);
  return static_cast<int>(cudaGetLastError());
}
