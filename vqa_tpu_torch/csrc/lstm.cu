// lstm_seq forward: the masked LSTM recurrence over precomputed input gates.
//
//   xg [T, B, 4H], mask [T, B, 1], wh [H, 4H] (bf16, gates in i, f, g, o order)
//   -> h_last [B, H] (the frozen carry), seq [T, B, H] (new_h * mask)
//
// Replaces vqa_tpu/ops/lstm.py::_lstm_seq_pallas (_pallas_fwd, _kernel): the
// Mosaic program that ran the whole recurrence for a batch tile with wh held
// in VMEM. On the H100 the flagship wh (2400 x 9600 bf16, 46 MB) fits in no
// SM's shared memory, so every step streams wh from L2 into the SMs.
//
// What bounds it on the H100: each step is the product h[B, H] x wh[H, 4H].
// At B=1024, H=2400 that is 47 GFLOP a step (47.7 us at the bf16 peak), bound
// by the tensor cores as long as the operands reach them: a tile of BM rows x
// BN columns re-reads h once per column tile and wh once per row tile, so a
// step pulls 2*H*B*4H*(1/BM + 1/BN) bytes through L2. At the serving batch
// (64) a step is bound by streaming the 46 MB of wh.
//
// The design. ops/lstm.py::lstm_plan picks the class kWG from B and H alone
// and passes it in; the wrapper's record names it.
//   - tile: BM = 64 * kWG batch rows x 64 hidden units of all four gates, a
//     product tile of N = 256 columns: one wgmma m64n256k16 per consumer
//     warpgroup and k16. Each gate strip is one 128-byte swizzle row, in
//     128-byte-swizzled shared memory for both operands. The four strips are
//     read at columns g*Gs + u0 of the flax-layout wh: no weight permutation.
//   - clusters (kWG = 2): two CTAs on neighbouring row tiles of one unit
//     tile share each wh stage; each loads two of the four gate strips and
//     multicasts them to both, so wh crosses L2 once per 256 rows.
//   - loads: TMA (one elected producer thread) into a ring of kStages stages,
//     each guarded by a full and an empty mbarrier. h is K-major (one box a
//     stage from a 3-D map over the two ping-pong buffers [2, B, Hp]); wh is
//     MN-major, four boxes a stage from the 2-D map [H, 4Gs]. Ragged B, H and
//     K edges come from TMA's zero fill.
//   - compute: kWG consumer warpgroups, each keeping one wgmma group in flight
//     (wait_group 1) and releasing a stage (in every CTA of the cluster) as
//     soon as the group that read it has retired. The producer warpgroup
//     gives registers up (setmaxnreg) so that the two consumer warpgroups of
//     kWG = 2 hold their 128 fp32 accumulators each.
//   - waves: a step runs full rounds of tiles over the clusters, then the
//     tiles left over, each shared by up to kMaxSplit clusters over K (at
//     B=1024, H=2400: 152 pair-tiles on 66 pairs, two rounds, then 20 tiles
//     x 3 instead of a third round on 20 pairs). The others write their fp32
//     partial products to global scratch and signal a counter; the owner
//     adds them to its own in split order and runs the epilogue.
//   - epilogue: the accumulator layout gives every thread all four gates of
//     its (row, unit) pairs. Each warp takes its 8 rows of a half at a time:
//     it issues every load at once (xg_t through a shared-memory slot in
//     16-byte chunks; c and h_{t-1} as fragments), runs the gate math in
//     fp32 (+xg_t, sigmoid and tanh to a few ulp, the c update, the mask
//     blend), and writes h, c and seq_t through its slots back to global
//     memory in 16-byte chunks. h and c are rounded to bf16 between steps, as
//     the Pallas kernel's h_scr/c_scr were; c is updated in place by the
//     thread that owns it.
//   - steps chained on the card: ONE persistent launch runs all T steps. Each
//     CTA owns the same tiles every step (so it alone reads and writes its c
//     and h elements in the epilogue), and a grid barrier (a counter in global
//     memory) separates the steps: a CTA's consumers publish their h stores
//     (proxy fence, then a release add) and its producer waits for every CTA
//     (acquire) before the TMA loads of the next step's h. wh does not depend
//     on h, so the producer issues the next step's first wh stages before it
//     waits. The launch is cooperative, so a grid that cannot be co-resident
//     is refused instead of hanging; the grid is sized from the occupancy of
//     clusters. Step 0 has no product (h and c start at zero). Results are
//     deterministic: the partial products are summed in a fixed order, and
//     no atomics touch the data.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;   // K tile: one 128-byte row of h
constexpr int kU = 64;    // hidden units a tile: one 128-byte row of each gate strip
constexpr int kN = 4 * kU;
constexpr int kMaxSplit = 3;  // clusters sharing a tail tile (registers of the owner's sum)

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

// ----------------------------------------------------------------- wgmma

// Shared-memory descriptor with the 128-byte swizzle. Measured on the H100
// (one-tile probes): K-major LBO unused / SBO = 1024, MN-major LBO = stride
// between 64-column blocks / SBO = 1024.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a >> 4) & 0x3FFF) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define VQA_A8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64x16, K-major) * B (16x256, MN-major), bf16 in, fp32 accumulate;
// then scale-d (p = true), scale-a, scale-b, tnsp-a 0, tnsp-b 1
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : VQA_A8(0), VQA_A8(8), VQA_A8(16), VQA_A8(24), VQA_A8(32), VQA_A8(40), VQA_A8(48),
        VQA_A8(56), VQA_A8(64), VQA_A8(72), VQA_A8(80), VQA_A8(88), VQA_A8(96), VQA_A8(104),
        VQA_A8(112), VQA_A8(120)
      : "l"(da), "l"(db));
}

// the gate nonlinearities in fp32, as the plain version's torch.sigmoid and
// torch.tanh: expf and tanhf (2 ulp each) and the reciprocal by __fdividef
// (2 ulp for a divisor below 2^126; past it the sigmoid is below 2^-126 and
// comes out 0). An IEEE division here made the kernel a fifth slower on the
// H100 (tools/lstm_cuda_probe.py --variants).
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + expf(-x)); }

// ------------------------------------------------------ epilogue staging

// A slot holds a warp's 8 rows x 64 units of one bf16 array: eight 128-byte
// rows, the 16-byte chunk c of row r at chunk c ^ r, so that neither the
// row-wise 16-byte accesses nor the fragment-wise 4-byte ones conflict.
constexpr int kSlot = 8 * 128;
constexpr int kWarpStaging = 4 * kSlot;  // the four gates of xg_t; then h, c, seq_t

// the bf16x2 of accumulator fragment ii of `lane`: row lane / 4, units
// 8 * ii + 2 * (lane % 4) + {0, 1}
__device__ __forceinline__ __nv_bfloat162* fragment(unsigned char* slot, int lane, int ii) {
  const int r = lane / 4;
  return reinterpret_cast<__nv_bfloat162*>(slot + r * 128 + ((ii ^ r) << 4) + (lane % 4) * 4);
}

// a lane's two 16-byte chunks of rows [row0, row0 + 8) x units [u0, u0 + 64)
// of src (row stride ld), zero past B and H; vec: src rows start on 16 bytes
__device__ __forceinline__ void load_rows(uint4 (&v)[2], const bf16* src, int64_t ld, int row0,
                                          int u0, int B, int H, bool vec, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = (lane + 32 * k) / 8, c = (lane + 32 * k) % 8;
    const int b = row0 + r, j = u0 + 8 * c;
    v[k] = make_uint4(0, 0, 0, 0);
    if (b >= B || j >= H) continue;
    const bf16* p = src + b * ld + j;
    if (vec) {
      v[k] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = j + 2 * e < H ? __ldg(reinterpret_cast<const unsigned*>(p + 2 * e)) : 0u;
      v[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void store_slot(unsigned char* slot, const uint4 (&v)[2], int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = (lane + 32 * k) / 8, c = (lane + 32 * k) % 8;
    *reinterpret_cast<uint4*>(slot + r * 128 + ((c ^ r) << 4)) = v[k];
  }
}

// the slot back to rows [row0, row0 + 8) x units [u0, u0 + 64) of dst, rows
// past B and units past H left alone (vec: whole chunks that start below H)
__device__ __forceinline__ void slot_to_rows(const unsigned char* slot, bf16* dst, int64_t ld,
                                             int row0, int u0, int B, int H, bool vec, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = (lane + 32 * k) / 8, c = (lane + 32 * k) % 8;
    const int b = row0 + r, j = u0 + 8 * c;
    if (b >= B || j >= H) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(slot + r * 128 + ((c ^ r) << 4));
    bf16* p = dst + b * ld + j;
    if (vec) {
      *reinterpret_cast<uint4*>(p) = v;
    } else {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + 2 * e < H) reinterpret_cast<unsigned*>(p)[e] = w[e];
    }
  }
}

// ---------------------------------------------------------- the kernel

template <int kWG, int kStages, int kC>
struct Plan {
  static constexpr int kBM = 64 * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;  // consumers first, then the producer
  static constexpr int kABytes = kBM * kBK * 2;      // h tile, 128-byte rows
  static constexpr int kBBytes = kBK * kN * 2;       // four gate strips of wh
  static constexpr int kStageBytes = kABytes + kBBytes;
  // after the stages: their full and empty barriers, then each consumer
  // warp's epilogue staging
  static constexpr int kStagingOff = kStages * kStageBytes + 128;
  static constexpr int kSmemBytes = 1024 + kStagingOff + (kConsumers / 32) * kWarpStaging;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-aligned for the swizzle");
};

struct Args {
  const bf16* xg;    // [T, B, 4H]
  const bf16* mask;  // [T, B]
  bf16* hbuf;        // [2, B, Hp], the ping-pong h of steps 0 .. T-2
  bf16* h_last;      // [B, H]
  bf16* c;           // [B, Hp], in place
  bf16* seq;         // [T, B, H]
  unsigned* count;   // zeroed before the launch: the grid barrier, then one
                     // counter a tail tile for its partial products
  float4* part;      // the tail tiles' partial products, [rem][split-1][kC][32][consumers]
  long long part_bytes;  // part's size (the host checks it)
  int T, B, H, Hp;
  int Gs;        // elements between wh's gate strips (H, or Hp in a padded copy)
  int split;     // clusters sharing a tail tile, each over its own K range
};

template <int kWG, int kStages, int kC>
__global__ void __launch_bounds__(Plan<kWG, kStages, kC>::kThreads, 1)
lstm_seq_kernel(const __grid_constant__ CUtensorMap h_map,  // [2][B][H] of hbuf, rows Hp
                const __grid_constant__ CUtensorMap w_map,  // [H][4Gs] of wh
                const Args a) {
  using P = Plan<kWG, kStages, kC>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * P::kStageBytes);
  uint64_t* empty = full + kStages;

  // a cluster of kC CTAs takes kC neighbouring row tiles of one unit tile
  // (a last odd row tile is paired with one past B, which TMA fills with
  // zeros and the epilogue skips), and each CTA multicasts 4 / kC of the wh
  // gate strips to all; tile -> (m0, u0) below
  unsigned rank = 0;
  if constexpr (kC > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int n_groups = ((a.B + P::kBM - 1) / P::kBM + kC - 1) / kC;
  const int n_tiles = n_groups * ((a.H + kU - 1) / kU);
  const int n_k = (a.H + kBK - 1) / kBK;
  const unsigned n_ctas = gridDim.x;
  const int cluster = blockIdx.x / kC, n_clusters = gridDim.x / kC;
  // a step's schedule: `rounds` full rounds of tiles over the clusters, then
  // the rem tiles left over, each shared by `split` clusters, each over its
  // own K range (split = 1: one cluster a tile; the host keeps
  // rem * split <= clusters). The owner (s = 0) of a shared tile adds the
  // others' fp32 partials to its own in split order, then runs its epilogue.
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * kC);  // every consumer warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (kC > 1) cluster_sync();

  if (threadIdx.x >= P::kConsumers) {
    // ------------------------------------------------------- producer
    if constexpr (kWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == P::kConsumers) {
    int stage = 0;
    unsigned phase = 0;
    auto advance = [&]() {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto load_b = [&](int s, int u0, int k0) {
      unsigned char* dst = smem + s * P::kStageBytes + P::kABytes;
      if constexpr (kC > 1) {
#pragma unroll
        for (int q = 0; q < 4 / kC; ++q) {
          const int g = (4 / kC) * rank + q;
          tma_2d_multicast(dst + g * (P::kBBytes / 4), &w_map, &full[s], g * a.Gs + u0, k0,
                           (1u << kC) - 1);
        }
      } else {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          tma_2d(dst + g * (P::kBBytes / 4), &w_map, &full[s], g * a.Gs + u0, k0);
      }
    };
    for (int t = 1; t < a.T; ++t) {
      const int src = (t - 1) & 1;  // h_{t-1}
      bool first = true;
      for (int it = 0; it < n_items; ++it) {
        int tile, s, parts;
        item(it, tile, s, parts);
        const int m0 = ((tile % n_groups) * kC + rank) * P::kBM, u0 = (tile / n_groups) * kU;
        const int k_lo = s * n_k / parts, k_hi = (s + 1) * n_k / parts;
        int kt = k_lo;
        if (first) {
          // wh does not depend on h: start this step's first stages before
          // every CTA has published h_{t-1}
          const int pre = k_hi - k_lo < kStages ? k_hi - k_lo : kStages;
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
            tma_3d(smem + s0 * P::kStageBytes, &h_map, &full[s0], (k_lo + i) * kBK, m0, src);
            if (++s0 == kStages) s0 = 0;
          }
          kt = k_lo + pre;
          first = false;
        }
        for (; kt < k_hi; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], P::kStageBytes);
          load_b(stage, u0, kt * kBK);
          tma_3d(smem + stage * P::kStageBytes, &h_map, &full[stage], kt * kBK, m0, src);
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
  if constexpr (kWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;
  const int64_t G4 = 4 * static_cast<int64_t>(a.H);
  const int64_t BH = static_cast<int64_t>(a.B) * a.H;
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
    const bf16* h_prev = a.hbuf + static_cast<int64_t>((t - 1) & 1) * a.B * a.Hp;
    bf16* h_next = a.hbuf + static_cast<int64_t>(t & 1) * a.B * a.Hp;
    const bool last = t == a.T - 1;
    const bf16* xg_t = a.xg + static_cast<int64_t>(t) * a.B * G4;
    for (int it = 0; it < n_items; ++it) {
      int tile, s, parts;
      item(it, tile, s, parts);
      const int m0 = ((tile % n_groups) * kC + rank) * P::kBM, u0 = (tile / n_groups) * kU;
      const int k_lo = s * n_k / parts, k_hi = (s + 1) * n_k / parts;
      // d[i*4 + e]: row 16*warp + lane/4 + (e/2)*8 of this warpgroup's 64,
      // column 8*i + (lane%4)*2 + e%2 = gate i / 8, unit 8*(i % 8) + ...
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      if (t > 0) {
        int prev = -1;
        for (int kt = k_lo; kt < k_hi; ++kt) {
          mbar_wait(&full[stage], phase);
          const unsigned char* sa = smem + stage * P::kStageBytes + wg * 64 * 128;
          const unsigned char* sb = smem + stage * P::kStageBytes + P::kABytes;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kBK; kk += 16) {
            // A: +32 bytes a k16; B: +16 swizzled rows (2048 bytes)
            wgmma_256(d, smem_desc(sa + kk * 2, 16, 1024), smem_desc(sb + kk * 128, kBK * 128, 1024));
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // keep this group in flight; the previous one has retired, so its
          // stage goes back to the producer
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (prev >= 0) release(prev);
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        release(prev);
      }
      if (parts > 1) {
        // a shared tail tile: partial q holds d[4q .. 4q+3] of every thread
        unsigned* done = a.count + 1 + (tile - n_full);
        auto partial = [&](int s2) {
          return a.part + (static_cast<int64_t>((tile - n_full) * (S - 1) + s2 - 1) * kC + rank) *
                              32 * P::kConsumers + tid;
        };
        if (s > 0) {  // hand the owner this K range's product
          if (t > 0) {
            float4* mine = partial(s);
#pragma unroll
            for (int q = 0; q < 32; ++q)
              __stcg(mine + q * P::kConsumers,
                     make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]));
            asm volatile("bar.sync 1, %0;\n" ::"n"(P::kConsumers) : "memory");
            if (tid == 0) release_add(done);
          }
          continue;
        }
        if (t > 0) {
          // every CTA of the other S - 1 clusters adds one a step
          if (tid == 0) acquire_wait(done, static_cast<unsigned>(t) * (S - 1) * kC);
          asm volatile("bar.sync 1, %0;\n" ::"n"(P::kConsumers) : "memory");
#pragma unroll
          for (int q0 = 0; q0 < 32; q0 += 4) {
            float4 p[kMaxSplit - 1][4];
#pragma unroll
            for (int s2 = 1; s2 < kMaxSplit; ++s2)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (s2 < S) p[s2 - 1][j] = __ldcg(partial(s2) + (q0 + j) * P::kConsumers);
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

      // epilogue: each warp's 8 rows of a half go through its staging slots,
      // so that global memory sees whole 16-byte chunks (vec: the rows start
      // on 16 bytes) while the gate math runs on the accumulator fragments,
      // two units (one bf16x2) at a time; H is even, so a pair never
      // straddles the edge
      unsigned char* slots = smem + P::kStagingOff + (tid / 32) * kWarpStaging;
      const bool vec = a.H % 8 == 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row0 = m0 + wg * 64 + 16 * warp + half * 8;
        const int b = row0 + lane / 4;
        // every load of the half at once: xg_t's rows, the mask, and the c and
        // h_{t-1} fragments (h_{t-1} was just read by TMA: an L2 hit)
        uint4 xr[4][2];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          load_rows(xr[g], xg_t + g * a.H, G4, row0, u0, a.B, a.H, vec, lane);
        const float m =
            b < a.B ? __bfloat162float(__ldg(a.mask + static_cast<int64_t>(t) * a.B + b)) : 0.f;
        __nv_bfloat162 xv[4][8], cv[8], hv[8];
        const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int j = u0 + ii * 8 + (lane % 4) * 2;
          const bool ok = b < a.B && j < a.H && t > 0;
          cv[ii] = ok ? *reinterpret_cast<const __nv_bfloat162*>(a.c + b * int64_t(a.Hp) + j) : zero;
          hv[ii] = ok ? *reinterpret_cast<const __nv_bfloat162*>(h_prev + b * int64_t(a.Hp) + j)
                      : zero;
        }
        __syncwarp();  // the last half's outputs have left the slots
#pragma unroll
        for (int g = 0; g < 4; ++g) store_slot(slots + g * kSlot, xr[g], lane);
        __syncwarp();
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) xv[g][ii] = *fragment(slots + g * kSlot, lane, ii);
        __syncwarp();  // every lane has read its xg
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          float gate[4][2];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float2 xf = __bfloat1622float2(xv[g][ii]);
            const int i = (g * 8 + ii) * 4 + half * 2;
            gate[g][0] = d[i] + xf.x;
            gate[g][1] = d[i + 1] + xf.y;
          }
          const float2 c_old = __bfloat1622float2(cv[ii]), h_old = __bfloat1622float2(hv[ii]);
          float hn[2], cn[2], sn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float co = e ? c_old.y : c_old.x, ho = e ? h_old.y : h_old.x;
            const float new_c = sigmoid(gate[1][e]) * co + sigmoid(gate[0][e]) * tanhf(gate[2][e]);
            const float new_h = sigmoid(gate[3][e]) * tanhf(new_c);
            hn[e] = m * new_h + (1.f - m) * ho;
            cn[e] = m * new_c + (1.f - m) * co;
            sn[e] = m * new_h;
          }
          *fragment(slots, lane, ii) = __floats2bfloat162_rn(hn[0], hn[1]);
          *fragment(slots + kSlot, lane, ii) = __floats2bfloat162_rn(cn[0], cn[1]);
          *fragment(slots + 2 * kSlot, lane, ii) = __floats2bfloat162_rn(sn[0], sn[1]);
        }
        __syncwarp();
        // hbuf and c rows are padded to Hp: whole chunks up to Hp may go
        if (last) {
          slot_to_rows(slots, a.h_last, a.H, row0, u0, a.B, a.H, vec, lane);
        } else {
          slot_to_rows(slots, h_next, a.Hp, row0, u0, a.B, a.H, true, lane);
        }
        slot_to_rows(slots + kSlot, a.c, a.Hp, row0, u0, a.B, a.H, true, lane);
        slot_to_rows(slots + 2 * kSlot, a.seq + static_cast<int64_t>(t) * BH, a.H, row0, u0, a.B,
                     a.H, vec, lane);
      }
    }
    if (!last) {
      // publish this step's h: generic stores, read next by TMA (the async
      // proxy) on other SMs
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(P::kConsumers) : "memory");
      if (tid == 0) release_add(a.count);
    }
  }
  if constexpr (kC > 1) cluster_sync();
}

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

template <int kWG, int kStages, int kC>
cudaError_t run(const bf16* wh, const Args& a, cudaStream_t s, long long* geometry) {
  using P = Plan<kWG, kStages, kC>;
  cudaError_t err;
  auto kernel = lstm_seq_kernel<kWG, kStages, kC>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = ((a.B + P::kBM - 1) / P::kBM + kC - 1) / kC * ((a.H + kU - 1) / kU);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(P::kThreads);
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
  const int grid = clusters * kC;
  cfg.gridDim = dim3(grid);
  // the tail: tiles left over after the full rounds, shared by K ranges
  Args b = a;
  const int n_k = (a.H + kBK - 1) / kBK;
  const int rounds = n_tiles / clusters, rem = n_tiles - rounds * clusters;
  b.split = 1;
  if (rounds > 0 && rem > 0) {
    b.split = clusters / rem;
    if (b.split > kMaxSplit) b.split = kMaxSplit;
    if (b.split > n_k) b.split = n_k;
  }
  const long long part_bytes =
      static_cast<long long>(rem) * (b.split - 1) * kC * 32 * P::kConsumers * sizeof(float4);
  if (geometry != nullptr) {
    geometry[0] = grid;
    geometry[1] = b.split;
    geometry[2] = part_bytes;
    geometry[3] = n_tiles * kC;
    geometry[4] = rem;
    geometry[5] = P::kSmemBytes;
    return cudaSuccess;
  }
  if (part_bytes > a.part_bytes) return cudaErrorInvalidValue;
  EncodeFn encode;
  err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap h_map, w_map;
  {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.H), static_cast<cuuint64_t>(a.B), 2};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.Hp) * 2,
                                   static_cast<cuuint64_t>(a.Hp) * 2 * a.B};
    const cuuint32_t box[3] = {kBK, P::kBM, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&h_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.hbuf, dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {4 * static_cast<cuuint64_t>(a.Gs), static_cast<cuuint64_t>(a.H)};
    const cuuint64_t strides[1] = {8 * static_cast<cuuint64_t>(a.Gs)};
    const cuuint32_t box[2] = {kU, kBK};
    const cuuint32_t estr[2] = {1, 1};
    if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(wh), dims, strides,
               box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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

int launch(const void* xg, const void* mask, const void* wh, void* h_last, void* seq, void* hbuf,
           void* c, void* count, void* part, long long part_bytes, int T, int B, int H, int gs,
           int wg, void* stream, long long* geometry = nullptr) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  // the epilogue moves two units at a time; a box starts on 16 bytes
  if (H % 2 != 0 || gs % 8 != 0 || gs < H) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(xg), static_cast<const bf16*>(mask), static_cast<bf16*>(hbuf),
         static_cast<bf16*>(h_last), static_cast<bf16*>(c), static_cast<bf16*>(seq),
         static_cast<unsigned*>(count), static_cast<float4*>(part), part_bytes, T, B, H,
         (H + 7) / 8 * 8, gs, 1};
  auto* w = static_cast<const bf16*>(wh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wg == 2) err = run<2, 4, 2>(w, a, s, geometry);
  else if (wg == 1) err = run<1, 5, 1>(w, a, s, geometry);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Runs all T steps in one launch on `stream`. wh's rows hold four gate
// strips `gs` elements apart (gs = H, or H rounded up to 8 in a zero-padded
// copy: a TMA box starts on 16 bytes). `wg` (1 or 2) is the class that
// ops/lstm.py::lstm_plan chose. hbuf is [2, B, Hp] and c [B, Hp] scratch
// (Hp = H rounded up to 8), count 1 + (tail tiles) uint32 of scratch, part
// part_bytes of scratch for the tail tiles' partial products (both as
// vqa_lstm_seq_geometry gives them). Returns the first non-zero cudaError_t, or 0.
extern "C" int vqa_lstm_seq(const void* xg, const void* mask, const void* wh, void* h_last,
                            void* seq, void* hbuf, void* c, void* count, void* part,
                            long long part_bytes, int T, int B, int H, int gs, int wg,
                            void* stream) {
  return launch(xg, mask, wh, h_last, seq, hbuf, c, count, part, part_bytes, T, B, H, gs, wg,
                stream);
}

// What vqa_lstm_seq launches at this shape and class on this card (its
// occupancy decides): geometry[0] the CTAs, [1] the clusters sharing each
// tail tile, [2] the bytes of partial-product scratch it needs, [3] the CTA
// tiles a step, [4] the tail tiles, [5] the shared memory of a CTA. Returns
// a cudaError_t.
extern "C" int vqa_lstm_seq_geometry(int B, int H, int wg, long long* geometry) {
  const int gs = (H + 7) / 8 * 8;
  return launch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                1, B, H, gs, wg, nullptr, geometry);
}
