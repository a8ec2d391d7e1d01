// lstm_seq forward in float32: the masked LSTM recurrence over precomputed
// input gates, every operand, output and carry in float32.
//
//   xg [T, B, 4H], mask [T, B, 1], wh [H, 4H] (float32, gates i, f, g, o)
//   -> h_last [B, H] (the frozen carry), seq [T, B, H] (new_h * mask)
//
// Replaces vqa_tpu/ops/lstm.py::_lstm_seq_pallas (_pallas_fwd, _kernel) on
// float32 inputs. The Pallas kernel computes in xg's dtype: its outputs and
// its h / c scratch take xg.dtype, so in float32 nothing is rounded between
// steps. Here h and c stay float32 from step to step, and the gate math is
// fp32 (expf, tanhf, IEEE division) as the plain version's torch.sigmoid/tanh.
//
// What bounds it on the H100: the products. Each step after the first is
// h[B, H] x wh[H, 4H]: at B=1024, H=2400, 47.2 GFLOP a step, 1.1797 TFLOP
// over T=26 (25 products): 17.6067 ms at the card's 67 TFLOP/s FP32 peak,
// which no kernel on the CUDA cores can beat. Single-pass TF32 on the tensor
// cores keeps ~3 decimal digits and misses float32's hold, so the products
// run as 3xTF32: each operand x split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi summed in fp32 (the
// dropped a_lo.b_lo is ~2^-22 relative): three passes at the 495 TFLOP/s
// TF32 peak, 7.15 ms at T=26. The bytes (xg and seq, 0.51 GB at T=26) take
// 0.15 ms at 3.35 TB/s.
//
// The design: csrc/lstm.cu's persistent kernel with tf32 operands.
//   - wgmma .tf32 takes B only K-major from shared memory (tf32 has no
//     transposed B), so the flax-layout wh [H, 4Gs] cannot be fed as it
//     lies: step 0, which has no product, also writes wh^T split into its
//     halves, wht [2][4 Hp][Hp] (row g Hp + u holds gate g, unit u over K;
//     zero past H), through a 32 x 32 shared-memory tile a warp. A (h) comes
//     from registers: an ldmatrix.x4 of the stage's h tile gives a warp's
//     tf32 fragment of a k8 (a 16-byte row of an 8 x 8 b16 matrix is four
//     tf32 in mma's fragment order), split into its halves there; h and c
//     stay float32 in [2, B, Hp] (ping-pong) and [B, Hp]. Feeding A's halves
//     from shared memory instead (h written three times a step) was a
//     quarter slower: a stage's bytes through L2 bind as much as its
//     products.
//   - the sum: the tensor cores' fp32 accumulation truncates, so a sum kept
//     in them over all of K drifts (1-2e-5 of the max-abs at K = 2400, ~20x
//     a per-stage fp32 sum's: enough to move the MFB family's grads through
//     its signed square root).
//   - two classes, chosen as the bf16 kernel chooses (ops/lstm.py::lstm_plan
//     with elem=4 reckons the same); both have two consumer warpgroups and
//     stages of K = 32 (one 128-byte swizzle row in either operand, as
//     bf16's 64): h's tile and wh^T's hi and lo [256, 32].
//     kWG = 1 (H=1024 at B=1024, the train and serving batches): a 64-row
//     tile, each warpgroup 32 units of every gate (so each thread holds all
//     four gates of its (row, unit) pairs), three stages of 72 KB. Each
//     stage's products (12 a gate) go into a fresh register set, added into
//     d in fp32 (round to nearest): its error is the plain float32
//     product's.
//     kWG = 2 (H=2400 at B >= 769, H=1024 at B >= 1793: the eval batch of
//     the 2400-unit archs, and a train batch set that large): 128-row tiles
//     in CTA pairs on neighbouring row tiles that multicast wh^T's strips
//     (wh^T crosses L2 once per 256 rows), each warpgroup 64 rows x all 256
//     columns, two stages of 80 KB. Its 128 sums a thread leave no registers
//     for a fresh set, so the sum stays in the tensor cores and this class's
//     numerics are the weaker (still inside the float32 hold); 64-row tiles
//     in clusters of 4 with it ran far slower at T=26 (a CTA's stage brings
//     twice the bytes a product).
//   - the rest is the bf16 kernel's: one producer thread issuing TMA into a
//     ring of full and empty mbarriers (its warpgroup gives registers up with
//     setmaxnreg), the tiles left after the full rounds shared over K by up
//     to 3 clusters (fp32 partials added in split order), ONE cooperative
//     launch for all T steps with a grid barrier between them (h published
//     with a proxy fence and a release add; the producer prefetches wh^T's
//     first stages of a step before it waits).
//   - epilogue: each thread holds all four gates of its (row, unit) pairs;
//     it reads xg_t, c and h_{t-1} and writes h, c and seq_t as 8-byte
//     fragments straight from the accumulator layout (a warp's access is 8
//     rows of 32 contiguous bytes: whole sectors).
// No atomics touch the data: two calls give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;  // K a stage: one 128-byte row of float32
constexpr int kU = 64;   // hidden units a tile (x 4 gates = 256 columns)
constexpr int kN = 4 * kU;
constexpr int kMaxSplit = 3;  // clusters sharing a tail tile
constexpr int kTile = 32;     // step 0's transposition: a warp's 32 x 32 tile
constexpr int kTileBytes = kTile * (kTile + 1) * 4;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // consumers first, then the producer

// the class: kWG = 1, 64-row tiles (each warpgroup 32 units of the tile's
// 64, a stage's sum added in fp32 registers); kWG = 2, 128-row tiles in CTA
// pairs (each warpgroup 64 rows x all 256 columns, the sum kept in the
// tensor cores)
template <int kWG>
struct Plan {
  static constexpr int kC = kWG;                 // CTAs a cluster
  static constexpr int kBM = 64 * kWG;           // batch rows a CTA
  static constexpr int kD = 64 * kWG;            // a consumer thread's sums
  static constexpr int kStages = kWG == 1 ? 3 : 2;  // as many as fit
  static constexpr int kAPlane = kBM * kBK * 4;       // h's tile (float32)
  static constexpr int kBPlane = kN * kBK * 4;        // wh^T's hi or lo: four gate strips
  static constexpr int kStageBytes = kAPlane + 2 * kBPlane;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 128;  // + the barriers
  static_assert(kAPlane % 1024 == 0 && kBPlane % 1024 == 0, "1024-aligned for the swizzle");
  static_assert((kConsumers / 32) * kTileBytes <= kStageBytes, "step 0's tiles fit a stage");
};

struct Args {
  const float* xg;    // [T, B, 4H]
  const float* mask;  // [T, B]
  const float* wh;    // [H, 4Gs]
  float* h_last;      // [B, H]
  float* seq;         // [T, B, H]
  float* hbuf;        // [2, B, Hp] ping-pong h of steps 0 .. T-2
  float* wht;         // [2][4 Hp, Hp] wh^T's tf32 halves
  float* c;           // [B, Hp], in place
  unsigned* count;    // zeroed before the launch: the grid barrier, then one
                      // counter a tail tile for its partial products
  float4* part;       // the tail tiles' partial products
  int T, B, H, Hp, Gs;
  int split;          // clusters sharing a tail tile, each over its own K range
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

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

// arrive on the barrier at `bar`'s offset in the shared memory of cluster CTA `rank`
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// ------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box into the same offset of every CTA of the cluster in `mask`, each
// completing its bytes on its own barrier at `bar`'s offset
__device__ __forceinline__ void tma_2d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                 int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// ------------------------------------------------------ grid-wide counters

__device__ __forceinline__ void release_add(unsigned* counter) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void acquire_wait(const unsigned* counter, unsigned target) {
  unsigned seen;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
  } while (seen < target);
}

// ------------------------------------------------------------ 3xTF32

// x as tf32: to nearest, ties away from zero (ops/_tf32.py::tf32_round)
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// Shared-memory descriptor, K-major with the 128-byte swizzle (LBO unused,
// SBO = 1024: eight 128-byte rows), as csrc/lstm.cu's probes settled it; a
// k8 of tf32 is 32 bytes, as a k16 of bf16
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a >> 4) & 0x3FFF) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define VQA_A8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64x8, registers) * B (8xN, K-major), tf32 in, fp32 accumulate,
// N = 32 (32 units of one gate) or 256 (all four gates' 64 units); scale_d
// 0 starts a fresh sum.
// A's fragment is mma.sync m16n8k8's for each warp's 16 rows: lane 4 g + t
// holds rows g, g + 8 at column t, then at column t + 4 (one ldmatrix.x4 of
// the 128-byte-swizzled tile gives them)
template <int kN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kN], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : VQA_A8(0), VQA_A8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[128], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : VQA_A8(0), VQA_A8(8), VQA_A8(16), VQA_A8(24), VQA_A8(32), VQA_A8(40), VQA_A8(48),
        VQA_A8(56), VQA_A8(64), VQA_A8(72), VQA_A8(80), VQA_A8(88), VQA_A8(96), VQA_A8(104),
        VQA_A8(112), VQA_A8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// an ldmatrix fragment x split into tf32 halves hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_frag(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float h = to_tf32(__uint_as_float(x[e]));
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(to_tf32(__uint_as_float(x[e]) - h));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// registers an in-flight wgmma reads or writes, kept in place until here
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------- the kernel

template <int kWG>
__global__ void __launch_bounds__(kThreads, 1)
lstm_f32_kernel(const __grid_constant__ CUtensorMap h_map,  // [2][B][H] of hbuf, rows Hp
                const __grid_constant__ CUtensorMap w_map,  // [8 Hp][H] of wht, rows Hp
                const Args a) {
  using P = Plan<kWG>;
  constexpr int kC = P::kC, kBM = P::kBM, kD = P::kD, kStages = P::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * P::kStageBytes);
  uint64_t* empty = full + kStages;

  // a cluster of kC CTAs takes kC neighbouring row tiles of one unit tile
  // (a last odd row tile is paired with one past B, which TMA fills with
  // zeros and the epilogue skips), and each CTA multicasts 4 / kC of the
  // gate strips to all; tile -> (m0, u0) below
  unsigned rank = 0;
  if constexpr (kC > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int n_groups = ceil_div(ceil_div(a.B, kBM), kC);
  const int n_tiles = n_groups * ceil_div(a.H, kU);
  const int n_k = ceil_div(a.H, kBK);
  const unsigned n_ctas = gridDim.x;
  const int cluster = blockIdx.x / kC, n_clusters = gridDim.x / kC;
  // a step's schedule: `rounds` full rounds of tiles over the clusters, then
  // the rem tiles left over, each shared by `split` clusters over K (the
  // owner, s = 0, adds the others' fp32 partials in split order)
  const int rounds = n_tiles / n_clusters;
  const int n_full = rounds * n_clusters, rem = n_tiles - n_full;
  const int S = a.split;
  const int n_items = rounds + (cluster < rem * S ? 1 : 0);
  auto item = [&](int i, int& tile, int& s, int& parts) {
    if (i < rounds) {
      tile = cluster + i * n_clusters, s = 0, parts = 1;
    } else {
      tile = n_full + cluster / S, s = cluster % S, parts = S;
    }
  };
  const int64_t plane = static_cast<int64_t>(a.B) * a.Hp;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kC);  // every consumer warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (kC > 1) cluster_sync();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      unsigned phase = 0;
      auto advance = [&]() {
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      // wh^T's hi and lo strips of units u0.. at K k0 (kC > 1: this CTA's
      // strips, multicast to the cluster)
      auto load_b = [&](int s, int u0, int k0) {
        unsigned char* dst = smem + s * P::kStageBytes + P::kAPlane;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int q = 0; q < 4 / kC; ++q) {
            const int g = (4 / kC) * rank + q;
            unsigned char* box = dst + p * P::kBPlane + g * (P::kBPlane / 4);
            const int row = (p * 4 + g) * a.Hp + u0;
            if constexpr (kC > 1) {
              tma_2d_multicast(box, &w_map, &full[s], k0, row, (1u << kC) - 1);
            } else {
              tma_2d(box, &w_map, &full[s], k0, row);
            }
          }
        }
      };
      // h_{t-1}'s rows m0.. at K k0
      auto load_a = [&](int s, int k0, int m0, int src) {
        tma_3d(smem + s * P::kStageBytes, &h_map, &full[s], k0, m0, src);
      };
      for (int t = 1; t < a.T; ++t) {
        const int src = (t - 1) & 1;  // h_{t-1}
        bool first = true;
        for (int it = 0; it < n_items; ++it) {
          int tile, s, parts;
          item(it, tile, s, parts);
          const int m0 = ((tile % n_groups) * kC + rank) * kBM, u0 = (tile / n_groups) * kU;
          const int k_lo = s * n_k / parts, k_hi = (s + 1) * n_k / parts;
          int kt = k_lo;
          if (first) {
            // wh^T does not depend on h: from step 2 on, start this step's
            // first stages before every CTA has published h_{t-1} (step 1
            // waits: step 0 writes wh^T, through the ring's shared memory)
            const int pre = t == 1 ? 0 : (k_hi - k_lo < kStages ? k_hi - k_lo : kStages);
            int s0 = stage;
            for (int i = 0; i < pre; ++i) {
              mbar_wait(&empty[stage], phase ^ 1);
              mbar_expect_tx(&full[stage], P::kStageBytes);
              load_b(stage, u0, (k_lo + i) * kBK);
              advance();
            }
            acquire_wait(a.count, static_cast<unsigned>(t) * n_ctas);
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
            for (int i = 0; i < pre; ++i) {
              load_a(s0, (k_lo + i) * kBK, m0, src);
              if (++s0 == kStages) s0 = 0;
            }
            kt = k_lo + pre;
            first = false;
          }
          for (; kt < k_hi; ++kt) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], P::kStageBytes);
            load_b(stage, u0, kt * kBK);
            load_a(stage, kt * kBK, m0, src);
            advance();
          }
        }
      }
    }
    // a CTA leaves only when its peers no longer multicast into it or
    // arrive on its barriers
    if constexpr (kC > 1) cluster_sync();
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int64_t G4 = 4 * static_cast<int64_t>(a.H);
  // a stage is free once every consumer warpgroup of the cluster has read it
  auto release = [&](int s) {
    if (tid % 128 != 0) return;
    if constexpr (kC > 1) {
#pragma unroll
      for (int r = 0; r < kC; ++r) mbar_arrive_cluster(&empty[s], r);
    } else {
      mbar_arrive(&empty[s]);
    }
  };
  int stage = 0;
  unsigned phase = 0;
  for (int t = 0; t < a.T; ++t) {
    const float* h_prev = a.hbuf + ((t - 1) & 1) * plane;
    float* h_next = a.hbuf + (t & 1) * plane;
    const bool last = t == a.T - 1;
    const float* xg_t = a.xg + static_cast<int64_t>(t) * a.B * G4;
    for (int it = 0; it < n_items; ++it) {
      int tile, s, parts;
      item(it, tile, s, parts);
      const int m0 = ((tile % n_groups) * kC + rank) * kBM, u0 = (tile / n_groups) * kU;
      const int k_lo = s * n_k / parts, k_hi = (s + 1) * n_k / parts;
      // kWG = 1: d[16 g + 4 i + e] is gate g, row 16 warp + lane / 4 + 8 (e /
      // 2) of the tile, unit 32 wg + 8 i + 2 (lane % 4) + e % 2 of its 64;
      // kWG = 2: d[32 g + 4 i + e] is gate g, row 64 wg + 16 warp + lane / 4
      // + 8 (e / 2), unit 8 i + 2 (lane % 4) + e % 2
      float d[kD];
#pragma unroll
      for (int i = 0; i < kD; ++i) d[i] = 0.f;
      if constexpr (kWG == 1) {
        if (t > 0) {
          // a stage at a time: A's fragments of its four k8 by ldmatrix from
          // the h tile, split into tf32 halves in registers; then each
          // gate's 32 units in their own group into a fresh sum (lo.hi,
          // hi.lo, hi.hi a k8), added into d in fp32 once the group has
          // retired (the next gate's group in flight meanwhile): the tensor
          // cores' fp32 accumulation truncates, and here it holds a stage's
          // 12 products; d's sum over the stages rounds to nearest.
          for (int kt = k_lo; kt < k_hi; ++kt) {
            mbar_wait(&full[stage], phase);
            const unsigned char* st = smem + stage * P::kStageBytes;
            uint32_t ah[4][4], al[4][4];
            const int row = 16 * warp + lane % 16;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              uint32_t x[4];
              ldsm_x4(x, smem_addr(st) + row * 128 + (((2 * kk + lane / 16) ^ (row & 7)) << 4));
              split_frag(x, ah[kk], al[kk]);
            }
            float ds[2][16];
            auto add = [&](int g, float (&src)[16]) {
              fence_acc(src);
#pragma unroll
              for (int i = 0; i < 16; ++i) d[16 * g + i] += src[i];
            };
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const unsigned char* b_hi = st + P::kAPlane + (64 * g + 32 * wg) * 128;
              asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                wgmma_tf32<16>(ds[g % 2], al[kk], smem_desc(b_hi + kk * 32), kk);
                wgmma_tf32<16>(ds[g % 2], ah[kk], smem_desc(b_hi + P::kBPlane + kk * 32), 1);
                wgmma_tf32<16>(ds[g % 2], ah[kk], smem_desc(b_hi + kk * 32), 1);
              }
              asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
              if (g > 0) {
                asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
                add(g - 1, ds[(g - 1) % 2]);
              }
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            add(3, ds[1]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              fence_regs(ah[kk]);
              fence_regs(al[kk]);
            }
            release(stage);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      } else if (t > 0) {
        // a k8 at a time into d (N = 256): A's fragments by ldmatrix, split
        // in registers (double-buffered: a k8's split overlaps the last
        // one's group), then lo.hi, hi.lo, hi.hi in one group; a stage goes
        // back to the producer once the group of its last k8 has retired
        // (checked at the next stage's second k8). 128 sums a thread leave no
        // registers for a fresh per-stage set: the sum stays in the tensor
        // cores (1-2e-5 of the max-abs at K = 2400, ~20x a per-stage sum's)
        uint32_t ah[2][4], al[2][4];
        int prev = -1;
        auto step = [&](const unsigned char* st, int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_regs(h);
          fence_regs(l);
          if (kk == 1 && prev >= 0) {  // the last stage's final group has retired
            release(prev);
            prev = -1;
          }
          const int row = wg * 64 + 16 * warp + lane % 16;
          uint32_t x[4];
          ldsm_x4(x, smem_addr(st) + row * 128 + (((2 * kk + lane / 16) ^ (row & 7)) << 4));
          split_frag(x, h, l);
          const unsigned char* b_hi = st + P::kAPlane + kk * 32;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          wgmma_tf32<128>(d, l, smem_desc(b_hi), 1);
          wgmma_tf32<128>(d, h, smem_desc(b_hi + P::kBPlane), 1);
          wgmma_tf32<128>(d, h, smem_desc(b_hi), 1);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        };
        for (int kt = k_lo; kt < k_hi; ++kt) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = smem + stage * P::kStageBytes;
          step(st, 0, ah[0], al[0]);
          step(st, 1, ah[1], al[1]);
          step(st, 2, ah[0], al[0]);
          step(st, 3, ah[1], al[1]);
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(ah[0]);
        fence_regs(al[0]);
        fence_regs(ah[1]);
        fence_regs(al[1]);
        fence_acc(d);
        release(prev);
      }
      if (parts > 1) {
        // a shared tail tile: partial q holds d[4q .. 4q+3] of every thread
        unsigned* done = a.count + 1 + (tile - n_full);
        auto partial = [&](int s2) {
          return a.part + (static_cast<int64_t>((tile - n_full) * (S - 1) + s2 - 1) * kC + rank) *
                              (kD / 4) * kConsumers + tid;
        };
        if (s > 0) {  // hand the owner this K range's product
          if (t > 0) {
            float4* mine = partial(s);
#pragma unroll
            for (int q = 0; q < kD / 4; ++q)
              __stcg(mine + q * kConsumers,
                     make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]));
            asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
            if (tid == 0) release_add(done);
          }
          continue;
        }
        if (t > 0) {
          // every CTA of the other S - 1 clusters adds one a step
          if (tid == 0) acquire_wait(done, static_cast<unsigned>(t) * (S - 1) * kC);
          asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
          for (int q0 = 0; q0 < kD / 4; q0 += 4) {
            float4 p[kMaxSplit - 1][4];
#pragma unroll
            for (int s2 = 1; s2 < kMaxSplit; ++s2)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (s2 < S) p[s2 - 1][j] = __ldcg(partial(s2) + (q0 + j) * kConsumers);
#pragma unroll
            for (int s2 = 1; s2 < kMaxSplit; ++s2)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (s2 < S) {
                  const int q = q0 + j;
                  d[4 * q] += p[s2 - 1][j].x;
                  d[4 * q + 1] += p[s2 - 1][j].y;
                  d[4 * q + 2] += p[s2 - 1][j].z;
                  d[4 * q + 3] += p[s2 - 1][j].w;
                }
          }
        }
      }

      // epilogue: rows lane/4 and lane/4 + 8 of the warp's 16, units u and
      // u + 1 of each 8-unit group ii (H is even and u is even, so both or
      // neither are real units); c and h_{t-1} were written by this thread
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = m0 + (kWG == 1 ? 0 : 64 * wg) + 16 * warp + lane / 4 + 8 * half;
        if (b >= a.B) continue;
        const float m = __ldg(a.mask + static_cast<int64_t>(t) * a.B + b);
        const float* xr = xg_t + b * G4;
        const int64_t row = b * static_cast<int64_t>(a.Hp);
#pragma unroll
        for (int ii = 0; ii < 4 * kWG; ++ii) {
          const int u = u0 + (kWG == 1 ? 32 * wg : 0) + ii * 8 + (lane % 4) * 2;
          if (u >= a.H) continue;
          float2 x[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) x[g] = __ldg(reinterpret_cast<const float2*>(xr + g * a.H + u));
          float2 c_old = make_float2(0.f, 0.f), h_old = make_float2(0.f, 0.f);
          if (t > 0) {
            c_old = *reinterpret_cast<const float2*>(a.c + row + u);
            h_old = *reinterpret_cast<const float2*>(h_prev + row + u);
          }
          float hn[2], cn[2], sn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = ii * 4 + half * 2 + e;  // gate g at d[kD / 4 g + i]
            const float pi = d[i] + (e ? x[0].y : x[0].x);
            const float pf = d[kD / 4 + i] + (e ? x[1].y : x[1].x);
            const float pc = d[kD / 2 + i] + (e ? x[2].y : x[2].x);
            const float po = d[3 * kD / 4 + i] + (e ? x[3].y : x[3].x);
            const float co = e ? c_old.y : c_old.x, ho = e ? h_old.y : h_old.x;
            const float new_c = sigmoid(pf) * co + sigmoid(pi) * tanhf(pc);
            const float new_h = sigmoid(po) * tanhf(new_c);
            cn[e] = m != 0.f ? new_c : co;
            hn[e] = m != 0.f ? new_h : ho;
            sn[e] = new_h * m;
          }
          *reinterpret_cast<float2*>(a.c + row + u) = make_float2(cn[0], cn[1]);
          float* h_dst = last ? a.h_last + b * static_cast<int64_t>(a.H) : h_next + row;
          *reinterpret_cast<float2*>(h_dst + u) = make_float2(hn[0], hn[1]);
          *reinterpret_cast<float2*>(a.seq + (static_cast<int64_t>(t) * a.B + b) * a.H + u) =
              make_float2(sn[0], sn[1]);
        }
      }
    }
    if (t == 0 && !last) {
      // wh^T split into its tf32 halves for the products of steps 1..T-1:
      // wht[p][g Hp + u][k] = half p of wh[k][g Gs + u], zero past H; each
      // consumer warp a 32 x 32 tile at a time through shared memory (the
      // ring is idle: the producers wait for this step's barrier)
      float* tile = reinterpret_cast<float*>(smem + (tid / 32) * kTileBytes);
      const int n_side = ceil_div(a.Hp, kTile);
      const long long n_tt = 4LL * n_side * n_side;
      const int warps = kConsumers / 32;
      const int64_t half_stride = 4LL * a.Hp * a.Hp;
      for (long long x = static_cast<long long>(blockIdx.x) * warps + tid / 32; x < n_tt;
           x += static_cast<long long>(gridDim.x) * warps) {
        const int kt = static_cast<int>(x % n_side), ut = static_cast<int>((x / n_side) % n_side);
        const int g = static_cast<int>(x / (static_cast<long long>(n_side) * n_side));
#pragma unroll 4
        for (int r = 0; r < kTile; ++r) {
          const int k = kt * kTile + r, u = ut * kTile + lane;
          tile[r * (kTile + 1) + lane] =
              k < a.H && u < a.H ? __ldg(a.wh + static_cast<int64_t>(k) * 4 * a.Gs + g * a.Gs + u)
                                 : 0.f;
        }
        __syncwarp();
#pragma unroll 4
        for (int r = 0; r < kTile; ++r) {
          const int u = ut * kTile + r, k = kt * kTile + lane;
          if (u < a.Hp && k < a.Hp) {
            const float v = tile[lane * (kTile + 1) + r];
            const float hi = to_tf32(v);
            float* dst = a.wht + (static_cast<int64_t>(g) * a.Hp + u) * a.Hp + k;
            dst[0] = hi;
            dst[half_stride] = to_tf32(v - hi);
          }
        }
        __syncwarp();
      }
    }
    if (!last) {
      // publish this step's h (and at step 0 wh^T): generic stores, read
      // next by TMA (the async proxy) on other SMs; step 0's shared-memory
      // tiles are the ring the TMA writes next
      asm volatile("fence.proxy.async;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (tid == 0) release_add(a.count);
    }
  }
  if constexpr (kC > 1) cluster_sync();
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

// the class: 128-row tiles in CTA pairs where they make at least 1.8 waves
// of the card's SMs (the bf16 kernel's rule), else 64-row tiles
// (ops/lstm.py::lstm_plan)
cudaError_t class_of(int B, int H, int* wg) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long pair_tiles = static_cast<long long>(ceil_div(B, 128)) * ceil_div(H, kU);
  *wg = 10 * pair_tiles >= 18LL * sms ? 2 : 1;
  return cudaSuccess;
}

// the scratch ahead of the partial products, in floats: h's ping-pong and
// wh^T's halves
long long fixed_scratch(int B, int Hp) {
  return 2LL * B * Hp + 8LL * Hp * Hp;
}

// geometry: [0] the CTAs, [1] the CTA tiles a step, [2] the shared memory of
// a CTA, [3] the CTAs a cluster, [4] the clusters sharing each tail tile,
// [5] the tail tiles, [6] the bytes of scratch, [7] the ring's stages
constexpr int kGeometry = 8;

template <int kWG>
cudaError_t run(const Args& a, cudaStream_t s, long long* geometry) {
  using P = Plan<kWG>;
  constexpr int kC = P::kC, kBM = P::kBM;
  auto kernel = lstm_f32_kernel<kWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = ceil_div(ceil_div(a.B, kBM), kC) * ceil_div(a.H, kU);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the grid: every CTA co-resident (the grid barrier waits on all of them)
  int resident = 0;
  cfg.gridDim = dim3(n_tiles * kC);
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return err;
  const int clusters = n_tiles < resident ? n_tiles : resident;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(clusters * kC);
  // the tail: tiles left over after the full rounds, shared by K ranges
  Args b = a;
  const int n_k = ceil_div(a.H, kBK);
  const int rounds = n_tiles / clusters, rem = n_tiles - rounds * clusters;
  b.split = 1;
  if (rounds > 0 && rem > 0) {
    b.split = clusters / rem;
    if (b.split > kMaxSplit) b.split = kMaxSplit;
    if (b.split > n_k) b.split = n_k;
  }
  const long long part_floats = 4LL * rem * (b.split - 1) * kC * (P::kD / 4) * kConsumers;
  if (geometry != nullptr) {
    const long long g[kGeometry] = {clusters * kC, static_cast<long long>(n_tiles) * kC,
                                    P::kSmemBytes, kC, b.split, rem,
                                    4 * (fixed_scratch(a.B, a.Hp) + part_floats), P::kStages};
    for (int i = 0; i < kGeometry; ++i) geometry[i] = g[i];
    return cudaSuccess;
  }
  b.wht = a.hbuf + 2LL * a.B * a.Hp;
  b.part = reinterpret_cast<float4*>(b.wht + 8LL * a.Hp * a.Hp);
  EncodeFn encode;
  err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap h_map, w_map;
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.H), static_cast<cuuint64_t>(a.B), 2};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.Hp) * 4,
                                   static_cast<cuuint64_t>(a.Hp) * 4 * a.B};
    const cuuint32_t box[3] = {kBK, kBM, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&h_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, b.hbuf, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.H), 8 * static_cast<cuuint64_t>(a.Hp)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.Hp) * 4};
    const cuuint32_t box[2] = {kBK, kU};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, b.wht, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  err = cudaMemsetAsync(a.count, 0, sizeof(unsigned) * (1 + rem), s);
  if (err != cudaSuccess) return err;
  cfg.numAttrs = 2;
  attr[1].id = cudaLaunchAttributeCooperative;  // co-resident, or refused
  attr[1].val.cooperative = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, h_map, w_map, b);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int launch(const void* xg, const void* mask, const void* wh, void* h_last, void* seq,
           void* scratch, void* c, void* count, int T, int B, int H, int gs, cudaStream_t s,
           long long* geometry = nullptr) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  // the epilogue moves two units at a time; a strip's rows stay inside wh's
  if (H % 2 != 0 || gs < H) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(xg), static_cast<const float*>(mask),
         static_cast<const float*>(wh), static_cast<float*>(h_last), static_cast<float*>(seq),
         static_cast<float*>(scratch), nullptr, static_cast<float*>(c),
         static_cast<unsigned*>(count), nullptr, T, B, H, (H + 7) / 8 * 8, gs, 1};
  int wg = 0;
  cudaError_t err = class_of(B, H, &wg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wg == 2 ? run<2>(a, s, geometry) : run<1>(a, s, geometry);
  return static_cast<int>(err);
}

}  // namespace

// Runs all T steps in one launch on `stream`, every pointer float32 (mask
// [T, B, 1] too). wh's rows hold four gate strips `gs` elements apart (gs =
// H, or H rounded up to 8 in a zero-padded copy: ops/lstm.py::gate_strips).
// H even (ops/lstm.py::pad_odd_hidden). scratch is the bytes that
// vqa_lstm_seq_f32_geometry names: h's ping-pong [2, B, Hp], wh^T's halves
// [2][4 Hp, Hp] and the tail tiles' partial products (Hp = H rounded up to
// 8); c [B, Hp] scratch; count
// 1 + (tail tiles) uint32 of scratch. Returns the first non-zero
// cudaError_t, or 0.
extern "C" int vqa_lstm_seq_f32(const void* xg, const void* mask, const void* wh, void* h_last,
                                void* seq, void* scratch, void* c, void* count, int T, int B,
                                int H, int gs, void* stream) {
  return launch(xg, mask, wh, h_last, seq, scratch, c, count, T, B, H, gs,
                static_cast<cudaStream_t>(stream));
}

// What vqa_lstm_seq_f32 launches at this shape on this card (its occupancy
// decides): geometry[0] the CTAs, [1] the CTA tiles a step, [2] the shared
// memory of a CTA, [3] the class (1 or 2 consumer warpgroups), [4] the
// clusters sharing each tail tile, [5] the tail tiles, [6] the bytes of
// scratch, [7] the ring's stages. Returns a cudaError_t.
extern "C" int vqa_lstm_seq_f32_geometry(int B, int H, long long* geometry) {
  return launch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, B, H,
                H, nullptr, geometry);
}
