// lstm_seq forward: the masked LSTM recurrence over precomputed input gates.
//
//   xg [T, B, 4H], mask [T, B, 1], wh [H, 4H] (bf16, gates in i, f, g, o order)
//   -> h_last [B, H] (the frozen carry), seq [T, B, H] (new_h * mask)
//
// Replaces vqa_tpu/ops/lstm.py::_lstm_seq_pallas (_pallas_fwd, _kernel): the
// Mosaic program that ran the whole recurrence for a batch tile with wh held
// in VMEM. On the H100 the flagship wh (2400 x 9600 bf16, 46 MB) fits in no
// SM's shared memory, so the recurrence is one launch per time step instead.
//
// What bounds it on the H100: each step is the product h[B, H] x wh[H, 4H].
// At B=1024, H=2400 that is 47 GFLOP a step, bound by the tensor cores. At the
// serving batch (64) each step re-reads the whole 46 MB wh for ~3 GFLOP, so it
// is bound by memory; 46 MB just fits in the 50 MB L2, so repeated steps can
// hit L2 rather than device memory.
//
// What the design does about it: one launch per step on the caller's stream,
// with ping-pong h buffers and c updated in place (each element of c is read
// and written by the same thread). A block computes 128 batch rows x 32 hidden
// units for all four gates (a 128 x 128 product tile): it reads the four column
// strips j, H+j, 2H+j and 3H+j of the flax-layout wh, so no weight permutation
// is needed. The K loop over H runs a 3-stage cp.async pipeline into shared
// memory, in the 128-byte-swizzled layout Hopper's warpgroup MMA reads at full
// rate (wgmma; h K-major, wh MN-major), and each of the two warpgroups runs
// m64n128k16 wgmma products into fp32 accumulators. The
// accumulator layout gives every thread complete gate quadruples (columns
// g*32 + u for g = 0..3), so the epilogue (+xg_t, sigmoid/tanh gates, the c
// update, the mask blend and the seq_t store, as the Pallas kernel's body)
// runs from registers. Gate math is fp32; h and c are stored in bf16 between
// steps, as the Pallas kernel's h_scr/c_scr were. Step 0 skips the product: h
// and c start at zero. Ragged B, H and K edges are zero-filled; H % 8 != 0
// takes scalar loads. Later work: TMA loads, a persistent grid, and wh
// pinned in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;           // batch rows per block: two warpgroups of 64
constexpr int kBN = 32;            // hidden units per block (x4 gates = 128 columns)
constexpr int kBK = 64;            // K tile
constexpr int kStages = 3;         // cp.async pipeline depth
constexpr int kThreads = 256;
constexpr int kTileBytes = 128 * kBK * 2;   // one operand tile (A or B), 16 KB
constexpr int kSmemBytes = kStages * 2 * kTileBytes + 1024;  // + room to align to 1024
// 128-byte swizzle: the 16-byte chunk c of a 128-byte row r (of an 8-row,
// 1024-byte atom) is stored at chunk c ^ (r % 8)
__device__ __forceinline__ int swizzle(int offset) { return offset ^ (((offset >> 7) & 7) << 4); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; when !valid it reads nothing and zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wgmma shared-memory descriptor with the 128-byte swizzle. For the K-major
// A (rows of 64 k): SBO = 1024 between 8-row groups, LBO unused (16). For the
// MN-major B (rows of 64 n per k): LBO = 8192 between the two 64-column
// blocks, SBO = 1024 between 8-row K groups. (Measured on the H100.)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a >> 4) & 0x3FFF) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define VQA_ACC8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A (64x16, K-major) * B (16x128, MN-major), bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : VQA_ACC8(0), VQA_ACC8(8), VQA_ACC8(16), VQA_ACC8(24), VQA_ACC8(32), VQA_ACC8(40),
        VQA_ACC8(48), VQA_ACC8(56)
      : "l"(desc_a), "l"(desc_b));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// One K tile of h (128 rows x kBK) and of the four wh strips (kBK x 128
// columns) into shared memory, 8 elements a chunk, 4 + 4 chunks a thread:
// neighbouring threads read neighbouring 16 bytes of a row, and the swizzle
// spreads each warp's stores over all 32 banks.
template <bool kVec>
__device__ __forceinline__ void load_tile(unsigned char* sA, unsigned char* sB,
                                          const bf16* __restrict__ h_in,
                                          const bf16* __restrict__ wh, int b0, int j0, int k0,
                                          int B, int H, int tid) {
  const int64_t G4 = 4 * static_cast<int64_t>(H);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = tid + q * kThreads;
    const int kc = c % 8, m = c / 8;                  // 8-element K chunk, row 0..127
    const int b = b0 + m, k = k0 + kc * 8;
    bf16* dst = reinterpret_cast<bf16*>(sA + swizzle(m * 128 + kc * 16));
    const bf16* src = h_in + static_cast<int64_t>(b) * H + k;
    if (kVec) {
      const bool ok = b < B && k < H;
      cp_async16(dst, ok ? src : h_in, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dst[e] = (b < B && k + e < H) ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = tid + q * kThreads;
    const int nc = c % 16, kr = c / 16;               // 8-column chunk (gate nc/4), K row
    const int k = k0 + kr, j = j0 + (nc % 4) * 8;
    bf16* dst = reinterpret_cast<bf16*>(sB + (nc / 8) * 8192 + swizzle(kr * 128 + (nc % 8) * 16));
    const bf16* src = wh + static_cast<int64_t>(k) * G4 + static_cast<int64_t>(nc / 4) * H + j;
    if (kVec) {
      const bool ok = k < H && j < H;
      cp_async16(dst, ok ? src : wh, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dst[e] = (k < H && j + e < H) ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
lstm_step_kernel(const bf16* __restrict__ xg_t,   // [B, 4H]
                 const bf16* __restrict__ mask_t, // [B]
                 const bf16* __restrict__ wh,     // [H, 4H]
                 const bf16* __restrict__ h_in,   // [B, H], unused at step 0
                 bf16* __restrict__ h_out,        // [B, H]
                 bf16* __restrict__ c,            // [B, H], in place
                 bf16* __restrict__ seq_t,        // [B, H]
                 int B, int H, int first) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of address bits 7-9: tiles start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int j0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // rows wg*64 .. +63 of the tile

  // d[i*4 + e]: row wg*64 + 16*warp + lane/4 + (e/2)*8, column 8*i + (lane%4)*2 + e%2,
  // i.e. gate i/4 of hidden unit (i%4)*8 + (lane%4)*2 + e%2
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  if (!first) {
    const int n_k = (H + kBK - 1) / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_k) load_tile<kVec>(smem + 2 * s * kTileBytes, smem + (2 * s + 1) * kTileBytes,
                                   h_in, wh, b0, j0, s * kBK, B, H, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      __syncthreads();               // everyone's have; tile kt-1 is no longer read
      const int next = kt + kStages - 1;
      if (next < n_k) {
        const int s = next % kStages;
        load_tile<kVec>(smem + 2 * s * kTileBytes, smem + (2 * s + 1) * kTileBytes, h_in, wh,
                        b0, j0, next * kBK, B, H, tid);
      }
      cp_async_commit();
      const unsigned char* a_tile = smem + 2 * (kt % kStages) * kTileBytes + wg * 64 * 128;
      const unsigned char* b_tile = smem + (2 * (kt % kStages) + 1) * kTileBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {  // k16 steps: +32 bytes in A, +2 K groups in B
        wgmma_m64n128k16(d, smem_desc(a_tile + kk * 2, 16, 1024),
                         smem_desc(b_tile + kk * 128, 8192, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    cp_async_wait<0>();
  }

  // Epilogue from registers: each thread holds all four gates of its elements.
  const int lane = tid % 32;
  const int64_t G4 = 4 * static_cast<int64_t>(H);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b = b0 + wg * 64 + 16 * ((tid % 128) / 32) + lane / 4 + half * 8;
    if (b >= B) continue;
    const bf16* x = xg_t + static_cast<int64_t>(b) * G4;
    const float m = __bfloat162float(mask_t[b]);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = j0 + ii * 8 + (lane % 4) * 2 + jj;
        if (j >= H) continue;
        const int e = half * 2 + jj;
        const float gi = d[(0 * 4 + ii) * 4 + e] + __bfloat162float(x[j]);
        const float gf = d[(1 * 4 + ii) * 4 + e] + __bfloat162float(x[H + j]);
        const float gg = d[(2 * 4 + ii) * 4 + e] + __bfloat162float(x[2 * H + j]);
        const float go = d[(3 * 4 + ii) * 4 + e] + __bfloat162float(x[3 * H + j]);
        const int64_t o = static_cast<int64_t>(b) * H + j;
        const float c_old = first ? 0.f : __bfloat162float(c[o]);
        const float h_old = first ? 0.f : __bfloat162float(h_in[o]);
        const float new_c = sigmoid(gf) * c_old + sigmoid(gi) * tanhf(gg);
        const float new_h = sigmoid(go) * tanhf(new_c);
        h_out[o] = __float2bfloat16(m * new_h + (1.f - m) * h_old);
        c[o] = __float2bfloat16(m * new_c + (1.f - m) * c_old);
        seq_t[o] = __float2bfloat16(m * new_h);
      }
  }
}

template <bool kVec>
cudaError_t run_steps(const bf16* xg, const bf16* mask, const bf16* wh, bf16* h_last, bf16* seq,
                      bf16* h_tmp, bf16* c, int T, int B, int H, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(lstm_step_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  const int64_t BH = static_cast<int64_t>(B) * H;
  bf16* bufs[2] = {h_last, h_tmp};
  const bf16* h_prev = nullptr;
  for (int t = 0; t < T; ++t) {
    bf16* h_next = bufs[(T - 1 - t) % 2];  // the last step writes h_last
    lstm_step_kernel<kVec><<<grid, kThreads, kSmemBytes, s>>>(
        xg + static_cast<int64_t>(t) * 4 * BH, mask + static_cast<int64_t>(t) * B, wh, h_prev,
        h_next, c, seq + static_cast<int64_t>(t) * BH, B, H, t == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    h_prev = h_next;
  }
  return cudaSuccess;
}

}  // namespace

// Runs all T steps, one launch each, on `stream`. h_tmp and c are [B, H]
// scratch. Returns the first non-zero cudaError_t, or 0.
extern "C" int vqa_lstm_seq(const void* xg, const void* mask, const void* wh, void* h_last,
                            void* seq, void* h_tmp, void* c, int T, int B, int H,
                            void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const bool vec = H % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(wh) | reinterpret_cast<uintptr_t>(h_last) |
                    reinterpret_cast<uintptr_t>(h_tmp)) % 16 == 0;
  auto* x = static_cast<const bf16*>(xg);
  auto* m = static_cast<const bf16*>(mask);
  auto* w = static_cast<const bf16*>(wh);
  auto* hl = static_cast<bf16*>(h_last);
  auto* sq = static_cast<bf16*>(seq);
  auto* ht = static_cast<bf16*>(h_tmp);
  auto* cc = static_cast<bf16*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec ? run_steps<true>(x, m, w, hl, sq, ht, cc, T, B, H, s)
                              : run_steps<false>(x, m, w, hl, sq, ht, cc, T, B, H, s);
  return static_cast<int>(err);
}
