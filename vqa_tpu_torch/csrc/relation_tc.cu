// relation_attend's "tc" design: the CoR relation core for N past the tiled
// design (bf16 N > ~570, float32 N > 256 at D=1024), both products on the
// tensor cores.
//
//   pg [B, N, D], r [B, N, D] (bf16 or float32)
//   s[b, i, j]     = sum_d pg[b, i, d] r[b, j, d] / sqrt(D)
//   out[b, i, :]   = sum_j softmax_j(s[b, i, :]) r[b, j, :]
//
// Replaces vqa_tpu/ops/relation.py::_relation_attend_pallas (_kernel) at
// the shapes csrc/relation.cu's tiled design cannot hold: s [64, N] fp32
// and a stage of N rows of r past the 227 KB a block may use (the 56 x 56
// grid of a 1792-pixel extract, N = 3136). The Pallas kernel computes the
// same thing; its numerics are kept: scores and softmax in fp32, alpha not
// rounded to the input type before the second product, the output rounded
// once.
//
// What bounds it on the H100: the two products, 4 B N^2 D operations (at
// B=64, N=3136, D=1024: 2.58 TFLOP, 2.6 ms at the 989 TFLOP/s bf16 peak);
// alpha's two bf16 halves double the second product. The scratch s
// (B N^2 fp32, 2.52 GB there) is written once and read once per column
// block of the output.
//
// Two kernels on one stream, each with the Hopper GEMM's shape: one
// producer warp keeps TMA loads (128-byte swizzle, 3-D maps that zero-fill
// past each element's N rows and D columns) in flight into a ring of
// stages on mbarriers, and two consumer warpgroups run wgmma, 64 rows of i
// each (288 threads, one CTA an SM).
//
// 1. scores (tc_scores_kernel): a CTA a tile of 128 rows i x kTile columns
//    j of one element. Both operands are K-major as they lie in memory (rows
//    of D). bf16: wgmma m64n256k16, A and B from shared memory. float32:
//    3xTF32 on wgmma m64n128k8 (pg from registers, an ldmatrix split into
//    tf32 halves there; r's box split by the consumers, hi in place and lo
//    beside it; a_lo b_hi + a_hi b_lo + a_hi b_hi), each stage's product
//    added into an fp32 register sum (the tensor cores' fp32 accumulation
//    truncates over a long K). The epilogue writes s = acc / sqrt(D) (fp32)
//    into scratch [B, N, ld] and, for each row, the tile's (max, sum of
//    exp) into stats [B, N, tiles, 2] (lse_merge.cuh's convention).
// 2. weighted sum (tc_sum_kernel): a CTA 128 rows of i and kCols columns of
//    d. It first merges its rows' tile statistics into (m, l) in tile order,
//    then walks r's rows in key stages: alpha = exp(s - m) / l from the
//    scratch tile (TMA), zero past N.
//    - bf16: out = alpha r as wgmma m64n256k16, alpha's two halves hi =
//      bf16(alpha), lo = bf16(alpha - hi) each as A from registers (~2^-16,
//      as csrc/relation.cu), r's tile as B, MN-major (tnsp-b).
//    - float32: tf32 B must be K-major, so out^T = r^T alpha^T as 3xTF32
//      m64n128k8: A = r's columns from registers (csrc/relation.cu's
//      weighted_chunk_f32 loads: 4-byte loads whose four rows hit 32
//      banks), B = alpha's tf32 halves written over the scratch tile (hi in
//      place, lo beside it); each stage's product added into fp32 registers.
// No atomics: every sum in a fixed order, so two calls give the same bits.
// The wrapper runs the batch in slices whose scratch fits its budget.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRows = 128;                 // rows of i a CTA, 64 a warpgroup

// bf16: scores 128 x 256 a CTA over 64 features a stage; the weighted sum
// 128 rows x 256 columns over 64 keys a stage
// float32: 128 x 128 over 32 features; 128 rows x 128 columns over 32 keys
template <typename T>
struct Tc;
template <>
struct Tc<bf16> {
  static constexpr int kTile = 256, kCols = 256, kK = 64, kScoreStages = 4, kSumStages = 3;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Tc<float> {
  static constexpr int kTile = 128, kCols = 128, kK = 32, kScoreStages = 4, kSumStages = 4;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the shared memory of each kernel: 1 KB to align the ring, the ring, its
// barriers (full, empty), and the weighted sum's (m, 1 / l) of its 128 rows
template <typename T>
struct Layout {
  static constexpr int kPgBytes = kRows * 128;                     // pg's box: 128 rows
  static constexpr int kRBytes = Tc<T>::kTile * 128;               // r's box: kTile rows
  static constexpr int kScoreStage = kPgBytes + kRBytes * (sizeof(T) == 4 ? 2 : 1);
  static constexpr int kSumR = Tc<T>::kK * Tc<T>::kCols * static_cast<int>(sizeof(T));
  static constexpr int kSumS = kRows * Tc<T>::kK * 4;              // the scratch tile
  static constexpr int kSumStage = kSumR + kSumS * (sizeof(T) == 4 ? 2 : 1);
  static constexpr int kScoreSmem = 1024 + Tc<T>::kScoreStages * (kScoreStage + 16);
  static constexpr int kSumSmem = 1024 + Tc<T>::kSumStages * (kSumStage + 16) + 2 * kRows * 4;
};

// ------------------------------------------------------------- primitives

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the box of `map` at (c0, c1, c2) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumer warps, without the producer
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t lds_u32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds_f2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// x as tf32: to nearest, ties away from zero (ops/_tf32.py::tf32_round)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// the float32 bits x as hi = tf32(x) and lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(__uint_as_float(x));
  lo = to_tf32(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void split_f32(float x, float& hi, float& lo) {
  hi = __uint_as_float(to_tf32(x));
  lo = __uint_as_float(to_tf32(x - hi));
}

// alpha at two neighbouring keys as bf16 pairs: hi = bf16(a), lo = bf16(a - hi)
__device__ __forceinline__ void split_bf16(float a0, float a1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a0 - hf.x, a1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ----------------------------------------------------------------- wgmma

// Shared-memory descriptor with the 128-byte swizzle, as csrc/lstm.cu's
// probes settled it: K-major LBO unused / SBO = 1024 (eight 128-byte rows),
// MN-major LBO = the stride between 64-column blocks / SBO = 1024
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo = 16,
                                              uint32_t sbo = 1024) {
  const uint64_t a = smem_addr(p);
  return ((a >> 4) & 0x3FFF) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// registers that an in-flight wgmma reads or writes, kept in place until here
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VQA_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define VQA_D64(i) VQA_D8(i), VQA_D8(i + 8), VQA_D8(i + 16), VQA_D8(i + 24), VQA_D8(i + 32), \
                   VQA_D8(i + 40), VQA_D8(i + 48), VQA_D8(i + 56)
// the accumulator lists of the asm strings below
#define VQA_REGS64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define VQA_REGS128                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "  \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "   \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "   \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "   \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "     \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "   \
  "%123, %124, %125, %126, %127}"

// d += A (64x16, K-major) * B (16x256, K-major), bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " VQA_REGS128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : VQA_D64(0), VQA_D64(64)
      : "l"(da), "l"(db));
}

// d += A (64x16, registers in mma.sync m16n8k16's fragment order for each
// warp's 16 rows) * B (16x256, MN-major: tnsp-b 1), bf16 in, fp32 accumulate
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " VQA_REGS128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : VQA_D64(0), VQA_D64(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d = A (64x8, registers in mma.sync m16n8k8's tf32 fragment order) * B
// (8x128, K-major) + (acc ? d : 0), tf32 in, fp32 accumulate
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " VQA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : VQA_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// ------------------------------------------------------------- the kernels

__device__ __forceinline__ unsigned char* align_ring(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// the ring's barriers: full (the producer's one arrival and the bytes),
// empty (one arrival per consumer warp)
template <int kStages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// scores: CTA (b, it, jt) computes s[b, 128 it.., kTile jt..] and the tile
// statistics of its rows
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
tc_scores_kernel(const __grid_constant__ CUtensorMap pg_map,
                 const __grid_constant__ CUtensorMap r_map, float* __restrict__ s,
                 float* __restrict__ stats, int N, int D, int ld) {
  using P = Tc<T>;
  using L = Layout<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int S = P::kScoreStages;
  constexpr int kAcc = P::kTile / 2;  // 64 x kTile a warpgroup over 128 threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::kScoreStage);
  uint64_t* empty = full + S;
  const int n_it = ceil_div(N, kRows), n_jt = ceil_div(N, P::kTile);
  const int jt = static_cast<int>(blockIdx.x % n_jt);
  const int it = static_cast<int>((blockIdx.x / n_jt) % n_it);
  const int b = static_cast<int>(blockIdx.x / (static_cast<unsigned>(n_jt) * n_it));
  const int i0 = it * kRows, j0 = jt * P::kTile;
  const int n_k = ceil_div(D, P::kK);
  const int tid = threadIdx.x, lane = tid % 32;
  init_ring<S>(full, empty);

  if (tid >= kConsumers) {  // the producer
    if (lane == 0) {
      for (int c = 0; c < n_k; ++c) {
        const int st = c % S;
        if (c >= S) mbar_wait(empty + st, ((c / S) - 1) & 1);
        unsigned char* base = ring + st * L::kScoreStage;
        mbar_expect_tx(full + st, L::kPgBytes + L::kRBytes);
        tma_3d(base, &pg_map, full + st, c * P::kK, i0, b);
        tma_3d(base + L::kPgBytes, &r_map, full + st, c * P::kK, j0, b);
      }
    }
    return;
  }

  const int wg = tid / 128, wq = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  float d[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) d[e] = 0.f;
  if constexpr (!kF32) {
    // a k16 a wgmma, a stage a group; the group before last has retired
    // when its stage goes back to the producer
    int prev = -1;
    for (int c = 0; c < n_k; ++c) {
      const int st = c % S;
      mbar_wait(full + st, (c / S) & 1);
      const unsigned char* a = ring + st * L::kScoreStage + wg * 64 * 128;
      const unsigned char* bb = ring + st * L::kScoreStage + L::kPgBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_bf16(d, smem_desc(a + kk * 32), smem_desc(bb + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(empty + prev, lane);
      prev = st;
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (prev >= 0) release(empty + prev, lane);
  } else {
    // 3xTF32, a k8 a group (A's registers double buffered); each stage's
    // product into a fresh accumulator, then added to d in fp32
    float acc[kAcc] = {};
    uint32_t ah[2][4], al[2][4];
    const int arow = wg * 64 + wq * 16 + lane % 16;  // this lane's ldmatrix row of pg's box
    for (int c = 0; c < n_k; ++c) {
      const int st = c % S;
      unsigned char* base = ring + st * L::kScoreStage;
      unsigned char* rb = base + L::kPgBytes;
      unsigned char* rlo = rb + L::kRBytes;
      mbar_wait(full + st, (c / S) & 1);
      // r's box split into tf32 halves: hi in place, lo at the same offset
      // of rlo (so the 128-byte swizzle carries over), a 16-byte piece a thread
#pragma unroll
      for (int q = tid; q < L::kRBytes / 16; q += kConsumers) {
        float4* p = reinterpret_cast<float4*>(rb) + q;
        const float4 v = *p;
        float4 h, l;
        split_f32(v.x, h.x, l.x);
        split_f32(v.y, h.y, l.y);
        split_f32(v.z, h.z, l.z);
        split_f32(v.w, h.w, l.w);
        *p = h;
        reinterpret_cast<float4*>(rlo)[q] = l;
      }
      fence_async_smem();
      consumers_sync();
      const unsigned a_row = smem_addr(base) + arow * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t(&h)[4] = ah[kk % 2];
        uint32_t(&l)[4] = al[kk % 2];
        wgmma_wait<1>();  // the group that read these registers has retired
        fence_regs(h);
        fence_regs(l);
        uint32_t x[4];
        ldsm_x4(x, a_row + (((2 * kk + lane / 16) ^ (arow & 7)) << 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(x[e], h[e], l[e]);
        wgmma_fence();
        wgmma_rs_tf32(acc, l, smem_desc(rb + kk * 32), kk > 0);
        wgmma_rs_tf32(acc, h, smem_desc(rlo + kk * 32), 1);
        wgmma_rs_tf32(acc, h, smem_desc(rb + kk * 32), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(ah[0]);
      fence_regs(al[0]);
      fence_regs(ah[1]);
      fence_regs(al[1]);
      fence_acc(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) d[e] += acc[e];
      release(empty + st, lane);
    }
  }

  // the epilogue: d[4 x + e] is s[i = i0 + 64 wg + 16 wq + g + 8 (e / 2),
  // j = j0 + 8 x + 2 t + e % 2] times sqrt(D); each row's (max, sum of exp)
  // over the tile's columns below N, reduced over the quad that holds it
  const float scale = rsqrtf(static_cast<float>(D));
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + wg * 64 + wq * 16 + g + 8 * h;
    float mx = neg_inf;
#pragma unroll
    for (int x = 0; x < kAcc / 4; ++x) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d[4 * x + 2 * h + e] *= scale;
        if (j0 + 8 * x + 2 * t + e < N) mx = fmaxf(mx, d[4 * x + 2 * h + e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < kAcc / 4; ++x) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (j0 + 8 * x + 2 * t + e < N) sum += expf(d[4 * x + 2 * h + e] - mx);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (i < N) {
      const int64_t row = static_cast<int64_t>(b) * N + i;
      float* srow = s + row * ld;
#pragma unroll
      for (int x = 0; x < kAcc / 4; ++x) {
        // j < N: a pair's second column is at most N, inside the row's ld
        const int j = j0 + 8 * x + 2 * t;
        if (j < N) {
          *reinterpret_cast<float2*>(srow + j) =
              make_float2(d[4 * x + 2 * h], d[4 * x + 2 * h + 1]);
        }
      }
      if (t == 0) {
        *reinterpret_cast<float2*>(stats + (row * n_jt + jt) * 2) = make_float2(mx, sum);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// weighted sum: CTA (b, it, dt) computes out[b, 128 it.., kCols dt..]
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
tc_sum_kernel(const __grid_constant__ CUtensorMap r_map,
              const __grid_constant__ CUtensorMap s_map, const float* __restrict__ stats,
              T* __restrict__ out, int N, int D) {
  using P = Tc<T>;
  using L = Layout<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int S = P::kSumStages;
  constexpr int kRBox = P::kK * 128;          // r's box: kK keys x one 128-byte row of columns
  constexpr int kRBoxes = P::kCols * static_cast<int>(sizeof(T)) / 128;
  constexpr int kSBox = kRows * 128;          // the scratch's box: 128 rows x 32 keys
  constexpr int kSBoxes = P::kK / 32;
  constexpr int kAcc = kF32 ? 64 : 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::kSumStage);
  uint64_t* empty = full + S;
  float* m_s = reinterpret_cast<float*>(empty + S);  // [128] each row's max
  float* inv_s = m_s + kRows;                        // [128] and 1 / its sum of exp
  const int n_it = ceil_div(N, kRows), n_dt = ceil_div(D, P::kCols);
  const int dt = static_cast<int>(blockIdx.x % n_dt);
  const int it = static_cast<int>((blockIdx.x / n_dt) % n_it);
  const int b = static_cast<int>(blockIdx.x / (static_cast<unsigned>(n_dt) * n_it));
  const int i0 = it * kRows, d0 = dt * P::kCols;
  const int n_k = ceil_div(N, P::kK);
  const int tid = threadIdx.x, lane = tid % 32;
  init_ring<S>(full, empty);

  if (tid >= kConsumers) {  // the producer
    if (lane == 0) {
      for (int c = 0; c < n_k; ++c) {
        const int st = c % S;
        if (c >= S) mbar_wait(empty + st, ((c / S) - 1) & 1);
        unsigned char* base = ring + st * L::kSumStage;
        mbar_expect_tx(full + st, L::kSumR + L::kSumS);
#pragma unroll
        for (int q = 0; q < kRBoxes; ++q) {
          tma_3d(base + q * kRBox, &r_map, full + st, d0 + q * (128 / static_cast<int>(sizeof(T))),
                 c * P::kK, b);
        }
#pragma unroll
        for (int q = 0; q < kSBoxes; ++q) {
          tma_3d(base + L::kSumR + q * kSBox, &s_map, full + st, c * P::kK + 32 * q, i0, b);
        }
      }
    }
    return;
  }

  // each row's tile statistics merged in tile order: m = max_c m_c,
  // l = sum_c l_c e^(m_c - m); rows past N get alpha 0
  if (tid < kRows) {
    const int i = i0 + tid, n_jt = ceil_div(N, P::kTile);
    float m = 0.f, inv = 0.f;
    if (i < N) {
      const float2* st =
          reinterpret_cast<const float2*>(stats) + (static_cast<int64_t>(b) * N + i) * n_jt;
      m = __int_as_float(0xff800000);
      for (int c = 0; c < n_jt; ++c) m = fmaxf(m, st[c].x);
      float l = 0.f;
      for (int c = 0; c < n_jt; ++c) {
        const float2 v = st[c];
        l += v.y * expf(v.x - m);
      }
      inv = 1.f / l;
    }
    m_s[tid] = m;
    inv_s[tid] = inv;
  }
  consumers_sync();

  const int wg = tid / 128, wq = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  float d[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) d[e] = 0.f;
  uint32_t ah[2][4], al[2][4];
  if constexpr (!kF32) {
    // out = alpha r: this thread's A rows rho, rho + 8 of the CTA's 128
    const int rho = wg * 64 + wq * 16 + g;
    const float m0 = m_s[rho], m1 = m_s[rho + 8], v0 = inv_s[rho], v1 = inv_s[rho + 8];
    for (int c = 0; c < n_k; ++c) {
      const int st = c % S;
      mbar_wait(full + st, (c / S) & 1);
      unsigned char* base = ring + st * L::kSumStage;
      const unsigned sb = smem_addr(base + L::kSumR);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t(&h)[4] = ah[kk % 2];
        uint32_t(&l)[4] = al[kk % 2];
        wgmma_wait<1>();  // the group that read these registers has retired
        fence_regs(h);
        fence_regs(l);
        // the A fragment: q = 2 c2 + hh is rows rho + 8 hh at keys
        // kk * 16 + 8 c2 + 2 t (+1) of the stage
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int col = (kk % 2) * 16 + 8 * c2 + 2 * t;  // within the 32-key box
          const int j = c * P::kK + kk * 16 + 8 * c2 + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = rho + 8 * hh;
            const float2 sv = lds_f2(sb + (kk / 2) * kSBox + row * 128 +
                                     (((col / 4) ^ (row & 7)) << 4) + (col % 4) * 4);
            const float m = hh ? m1 : m0, inv = hh ? v1 : v0;
            const float a0 = j < N ? expf(sv.x - m) * inv : 0.f;
            const float a1 = j + 1 < N ? expf(sv.y - m) * inv : 0.f;
            split_bf16(a0, a1, h[2 * c2 + hh], l[2 * c2 + hh]);
          }
        }
        wgmma_fence();
        // B: keys kk * 16.. of r's four 64-column boxes (+16 swizzled rows a k16)
        const uint64_t db = smem_desc(base + kk * 16 * 128, kRBox, 1024);
        wgmma_rs_bf16(d, h, db);
        wgmma_rs_bf16(d, l, db);
        wgmma_commit();
      }
      // the stage's groups retire before the next stage's A registers are
      // written (with groups in flight across stages, ptxas serialized
      // every wgmma, C7513; the time was the same), then its stage goes
      // back to the producer
      wgmma_wait<0>();
      fence_regs(ah[0]);
      fence_regs(al[0]);
      fence_regs(ah[1]);
      fence_regs(al[1]);
      release(empty + st, lane);
    }
    fence_acc(d);
    // d[4 x + e] is out[i0 + rho + 8 (e / 2), d0 + 8 x + 2 t + e % 2]
    bf16* ob = reinterpret_cast<bf16*>(out) + static_cast<int64_t>(b) * N * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + rho + 8 * hh;
      if (i < N) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int col = d0 + 8 * x + 2 * t;
          if (col < D) store_pair(ob + static_cast<int64_t>(i) * D + col, d[4 * x + 2 * hh],
                                  d[4 * x + 2 * hh + 1]);
        }
      }
    }
  } else {
    // out^T = r^T alpha^T, 3xTF32: warpgroup wg takes the CTA's columns
    // 64 wg.. (r's boxes 2 wg, 2 wg + 1), warp wq the box 2 wg + wq / 2 and
    // its half wq % 2; A row m = 16 wq + g + 8 h is that box's column
    // 4 (2 (wq % 2) + h + 4 (g / 4)) + g % 4 (csrc/relation.cu's
    // weighted_chunk_f32 loads)
    float acc[kAcc] = {};
    const int half = wq % 2;
    const int p0 = 2 * half + 4 * (g / 4), p1 = p0 + 1;
    const unsigned colb = (g % 4) * 4;
    for (int c = 0; c < n_k; ++c) {
      const int st = c % S;
      unsigned char* base = ring + st * L::kSumStage;
      unsigned char* hi = base + L::kSumR;  // the scratch's box, then alpha's hi half
      unsigned char* lo = hi + L::kSumS;
      mbar_wait(full + st, (c / S) & 1);
      // alpha = exp(s - m) / l, zero past N, as tf32 halves: hi over the
      // box, lo beside it at the same offset; a 16-byte piece a thread
#pragma unroll
      for (int q = tid; q < kSBox / 16; q += kConsumers) {
        const int row = q / 8, piece = (q % 8) ^ (row & 7);  // the piece's keys 4 piece..
        const int j = c * P::kK + 4 * piece;
        const float m = m_s[row], inv = inv_s[row];
        float4* p = reinterpret_cast<float4*>(hi) + q;
        const float4 v = *p;
        float4 ph, pl;
        split_f32(j < N ? expf(v.x - m) * inv : 0.f, ph.x, pl.x);
        split_f32(j + 1 < N ? expf(v.y - m) * inv : 0.f, ph.y, pl.y);
        split_f32(j + 2 < N ? expf(v.z - m) * inv : 0.f, ph.z, pl.z);
        split_f32(j + 3 < N ? expf(v.w - m) * inv : 0.f, ph.w, pl.w);
        *p = ph;
        reinterpret_cast<float4*>(lo)[q] = pl;
      }
      fence_async_smem();
      consumers_sync();
      const unsigned r_base = smem_addr(base + (2 * wg + wq / 2) * kRBox);
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t(&h)[4] = ah[kt % 2];
        uint32_t(&l)[4] = al[kt % 2];
        wgmma_wait<1>();  // the group that read these registers has retired
        fence_regs(h);
        fence_regs(l);
        const int j0 = kt * 8 + t, j1 = j0 + 4;  // the stage's keys t, t + 4 of this k8
        uint32_t a[4];
        a[0] = lds_u32(r_base + j0 * 128 + ((p0 ^ (j0 & 7)) << 4) + colb);
        a[1] = lds_u32(r_base + j0 * 128 + ((p1 ^ (j0 & 7)) << 4) + colb);
        a[2] = lds_u32(r_base + j1 * 128 + ((p0 ^ (j1 & 7)) << 4) + colb);
        a[3] = lds_u32(r_base + j1 * 128 + ((p1 ^ (j1 & 7)) << 4) + colb);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], h[e], l[e]);
        wgmma_fence();
        wgmma_rs_tf32(acc, l, smem_desc(hi + kt * 32), kt > 0);
        wgmma_rs_tf32(acc, h, smem_desc(lo + kt * 32), 1);
        wgmma_rs_tf32(acc, h, smem_desc(hi + kt * 32), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(ah[0]);
      fence_regs(al[0]);
      fence_regs(ah[1]);
      fence_regs(al[1]);
      fence_acc(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) d[e] += acc[e];
      release(empty + st, lane);
    }
    // d[4 x + e] is out[i0 + 8 x + 2 t + e % 2, column of A row
    // 16 wq + g + 8 (e / 2)]
    float* ob = reinterpret_cast<float*>(out) + static_cast<int64_t>(b) * N * D;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int col = d0 + 64 * wg + 32 * (wq / 2) + 4 * (2 * half + e2 + 4 * (g / 4)) + g % 4;
      if (col < D) {
#pragma unroll
        for (int x = 0; x < 16; ++x) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int i = i0 + 8 * x + 2 * t + e1;
            if (i < N) ob[static_cast<int64_t>(i) * D + col] = d[4 * x + 2 * e2 + e1];
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled is a driver entry point; reach it through the runtime
// so that the library links against nothing but cudart.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeFn* fn) {
  static EncodeFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a 3-D map [B, rows, cols] (row stride `ld` elements) in boxes of one
// 128-byte row x `box_rows` rows x 1, 128-byte swizzle, zero past each end
cudaError_t encode_3d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                      int B, int rows, int cols, int64_t ld, int box_rows) {
  EncodeFn encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * elem,
                                 static_cast<cuuint64_t>(ld) * elem * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// what each of the two launches runs: CTAs, threads, shared memory
struct Geometry {
  long long ctas, cluster, threads, smem;
};

template <typename T>
cudaError_t geometry_of(int B, int N, int D, int which, Geometry* g) {
  using P = Tc<T>;
  const long long tiles = static_cast<long long>(B) * ceil_div(N, kRows);
  if (which == 0) {
    *g = {tiles * ceil_div(N, P::kTile), 1, kThreads, Layout<T>::kScoreSmem};
  } else if (which == 1) {
    *g = {tiles * ceil_div(D, P::kCols), 1, kThreads, Layout<T>::kSumSmem};
  } else {
    return cudaErrorInvalidValue;
  }
  return g->ctas < (1LL << 31) ? cudaSuccess : cudaErrorInvalidValue;
}

// the row stride of the scratch s (floats): N rounded up to 4, 16-byte rows
int scratch_ld(int N) { return ceil_div(N, 4) * 4; }

// one of the design's two launches (`which` 0: the scores, 1: the weighted sum)
template <typename T>
int launch(const void* pg, const void* r, void* out, void* s, void* stats, int B, int N, int D,
           int which, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides
  if (D % 8 != 0 || ((reinterpret_cast<uintptr_t>(pg) | reinterpret_cast<uintptr_t>(r) |
                      reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(s)) % 16) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using P = Tc<T>;
  Geometry g;
  cudaError_t err = geometry_of<T>(B, N, D, which, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ld = scratch_ld(N);
  auto* sp = static_cast<float*>(s);
  auto* stp = static_cast<float*>(stats);
  CUtensorMap a_map, b_map;
  if (which == 0) {
    err = encode_3d(&a_map, P::kType, sizeof(T), pg, B, N, D, D, kRows);
    if (err == cudaSuccess) err = encode_3d(&b_map, P::kType, sizeof(T), r, B, N, D, D, P::kTile);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tc_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_scores_kernel<T><<<static_cast<unsigned>(g.ctas), kThreads, static_cast<size_t>(g.smem),
                          stream>>>(a_map, b_map, sp, stp, N, D, ld);
  } else {
    err = encode_3d(&a_map, P::kType, sizeof(T), r, B, N, D, D, P::kK);
    if (err == cudaSuccess)
      err = encode_3d(&b_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s, B, N, N, ld, kRows);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tc_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_sum_kernel<T><<<static_cast<unsigned>(g.ctas), kThreads, static_cast<size_t>(g.smem),
                       stream>>>(a_map, b_map, stp, static_cast<T*>(out), N, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of relation_attend's "tc" design on `stream`, in bf16 (`elem`
// 2) or float32 (`elem` 4): `which` 0, the scores into s [B, N, ld] (fp32,
// ld = N rounded up to 4) and their tile statistics into stats
// [B, N, tiles, 2] (scratch the caller allocates; tiles = ceil(N / 256) in
// bf16, ceil(N / 128) in float32); `which` 1, the weighted sum from them
// into out. The caller launches 0 then 1 on one stream. Needs D % 8 == 0
// and every pointer on 16 bytes. Returns the launch's cudaError_t, or 0.
extern "C" int vqa_relation_attend_tc(const void* pg, const void* r, void* out, void* s,
                                      void* stats, int B, int N, int D, int elem, int which,
                                      void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (elem == 2) return launch<bf16>(pg, r, out, s, stats, B, N, D, which, st);
  if (elem == 4) return launch<float>(pg, r, out, s, stats, B, N, D, which, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What vqa_relation_attend_tc launches for B elements: `which` 0 the
// scores, 1 the weighted sum; geometry[0] the CTAs, [1] the cluster size,
// [2] the threads of a CTA, [3] its shared memory. Returns a cudaError_t.
extern "C" int vqa_relation_tc_geometry(int B, int N, int D, int which, int elem,
                                        long long* geometry_out) {
  Geometry geo;
  cudaError_t err = cudaErrorInvalidValue;
  if (B > 0 && N > 0 && D > 0) {
    if (elem == 2) err = geometry_of<bf16>(B, N, D, which, &geo);
    if (elem == 4) err = geometry_of<float>(B, N, D, which, &geo);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  geometry_out[0] = geo.ctas;
  geometry_out[1] = geo.cluster;
  geometry_out[2] = geo.threads;
  geometry_out[3] = geo.smem;
  return 0;
}
