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
// fp32; each output rounded once. The softmax subtracts the row's max in
// fp32, so a row whose logits are all the mask value finfo(bf16).min (an
// all-padding question in MFB's self-attention) gives uniform alpha, as
// jax.nn.softmax does, not nan. No atomics: two calls give the same bits.
//
// What bounds it on the H100: memory, by the bytes. glimpse_head, per batch
// row, reads joint once (36 x 510 bf16, 37 KB) and v once (36 x 2048 bf16,
// 147 KB) for ~0.4 MFLOP: ~189 MB at B=1024, far below the card's ~295
// FLOP/byte balance point. glimpse_attend at MFB's question self-attention
// (B=1024, T <= 26, G=2, D=1024) reads at most 54.5 MB of v and writes
// 4 MB. In practice a row's serial steps (logits, softmax, weighted sum)
// bound it: cut variants (vqa_tpu_torch/tools/glimpse_probe.py --cuts) show
// the v bytes costing less than the math around them (PERF.md, Findings).
//
// Three designs, ops/attention.py::glimpse_plan choosing by shape (the
// third, "split", for alpha [R, G] past shared memory, in either type: see
// glimpse_split_kernel):
//
// The ring (glimpse_kernel, mode bulk): v's bytes move first.
//   - A row's D columns are split over a cluster of `split` CTAs (2 at
//     D=2048, more at the serving batch so that B x split CTAs fill the
//     132 SMs); each CTA computes the logits of its share of the regions.
//   - At its start a CTA issues 1-D bulk async copies (cp.async.bulk) on
//     mbarriers: first w and its regions' joint slice (16-byte granules
//     around them), then v (one copy per region row of its columns) into a
//     ring of `stages` stages of `chunk` regions. Where the whole slice fits
//     (up to 96 KB) every byte is in flight before any math; else (R=196 at
//     D=2048) the ring is refilled as stages are consumed.
//   - The logits from shared memory, one warp a region, lanes over pairs of
//     joint values, every glimpse in groups of 4, a shuffle reduction; each
//     logit stored into the alpha array of every CTA of the cluster (DSMEM),
//     so joint is read once per row. glimpse_attend reads the given logits
//     (loaded ahead of the copies).
//   - The softmax one warp a (row, glimpse), lanes over regions.
//   - The weighted sum consumes each stage as it lands: a thread owns 4
//     columns of one row for a group of 4 glimpses (alpha padded with zero
//     glimpses, read as float4, the padding skipped), so any G runs as
//     groups; more items than threads take several passes. 8-byte stores.
//   - D % 8 != 0 or an unaligned pointer takes the generic path (mode
//     plain): the same kernel with plain copies into one stage.
//   Shared memory is opted in up to what the card allows; where alpha [R, G]
//   and one region of a CTA's columns cannot fit, the split design runs.
//   It runs glimpse_attend, glimpse_head at the serving batch, G > 4 and the
//   196-region grid.
//
// The parent (glimpse_parent_kernel, mode parent): the one-block-a-row
// kernel that this file held before, kept where nothing above beat it on
// the card: glimpse_head at batch 1024.
//
// float32 (glimpse_f32_kernel, the entries vqa_glimpse_head_f32 and
// vqa_glimpse_attend_f32): the Pallas kernels computed in their input's
// dtype, so in float32 nothing is rounded: logits, softmax, alpha and the
// weighted sum in fp32, each output stored as it is. One design for every
// shape whose alpha [R, G] fits (past it, the split design below), the
// parent's plan: one 256-thread block a batch row; w in fp32
// shared memory where it fits beside alpha (else read from device memory
// through L1); the logits one warp a region, glimpses in groups of 4; the
// softmax one warp a glimpse; the weighted sum a thread 4 columns (16-byte
// loads of v, D % 4 == 0 and 16-byte pointers; else one column) for a group
// of 4 glimpses, v streamed from device memory once a group. Any G and R:
// it needs only alpha [R, G] in shared memory. In float32 the bytes double
// (B=1024, R=36, M=510, G=2, D=2048: ~378 MB, 0.113 ms at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lse_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;     // glimpses a thread accumulates at once
constexpr int kMaxSplit = 8;  // the portable cluster size
// how v (and staged joint and w) reach shared memory; see glimpse_kernel
constexpr int kModePlain = 0;
constexpr int kModeBulk = 1;
constexpr int kModeParent = 2;

struct Params {
  const bf16* joint;      // [B, R, M] (glimpse_head)
  const bf16* w;          // [M, G]
  const bf16* bias;       // [G]
  const bf16* logits_in;  // [B, R, G] (glimpse_attend)
  const bf16* v;          // [B, R, D]
  bf16* out;              // [B, G, D]
  bf16* logits_out;       // [B, R, G] (glimpse_head)
  int B, R, M, G, D;
  int split;   // CTAs (one cluster) sharing a row's D columns
  int chunk;   // regions a ring stage holds, per row
  int stages;  // ring stages
  int staged;  // glimpse_head: w and the CTA's joint slice copied into shared memory
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// shared memory of one CTA, byte offsets: the barriers (the ring's stages,
// then joint's); alpha [R, gp] (fp32, gp = G rounded up to kGroup);
// the bias (fp32); where `staged`, w as bf16 with up to 16 bytes of lead
// (copied from 16 bytes below it) and the CTA's joint slice (its regions,
// likewise);
// the ring: `stages` stages of `chunk` regions of D / split columns, or,
// where it holds every chunk (resident), exactly R regions
struct Layout {
  size_t alpha, bias, w, joint, seg, ring, total;
};

__host__ __device__ inline Layout layout(int R, int M, int G, int dc, int split, int chunk,
                                         int stages, bool staged) {
  Layout l;
  const size_t gp = static_cast<size_t>(ceil_div(G, kGroup)) * kGroup;
  const size_t nper = ceil_div(R, split);
  const size_t regions = stages >= ceil_div(R, chunk) ? R : static_cast<size_t>(stages) * chunk;
  l.alpha = align16(static_cast<size_t>(stages + 1) * 8);
  l.bias = l.alpha + align16(static_cast<size_t>(R) * gp * 4);
  l.w = l.bias + align16(gp * 4);
  l.joint = l.w + (staged ? align16(static_cast<size_t>(M) * G * 2 + 16) : 0);
  l.seg = staged ? align16(nper * M * 2 + 16) : 0;
  l.ring = l.joint + l.seg;
  l.total = l.ring + align16(regions * dc * 2);
  return l;
}

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

// `bytes` (a multiple of 16, both addresses on 16 bytes) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// store x at `p`'s offset in the shared memory of cluster CTA `rank`
__device__ __forceinline__ void st_cluster(float* p, unsigned rank, float x) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.f32 [remote], %2;\n}\n" ::"r"(smem_addr(p)),
      "r"(rank), "f"(x)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

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

union Pack8 {
  uint4 u;
  bf16 h[8];
};

union Pack4 {
  uint2 u;
  __nv_bfloat162 h[2];
};

template <int W>
__device__ __forceinline__ void load_cols(const bf16* p, float (&x)[W]) {
  if constexpr (W == 4) {
    Pack4 q;
    q.u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(q.h[0]), b = __bfloat1622float2(q.h[1]);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int W>
__device__ __forceinline__ void store_cols(bf16* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    Pack4 q;
    q.h[0] = __floats2bfloat162_rn(x[0], x[1]);
    q.h[1] = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = q.u;
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

// a staged array is copied in 16-byte pieces from the 16 bytes at or below
// its first element (`stage_lead` elements of lead) over stage_span() bytes;
// the bytes read past either end share a 16-byte granule with the array
__device__ __forceinline__ int stage_lead(const bf16* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / 2);
}

__device__ __forceinline__ const bf16* stage_base(const bf16* src) {
  return reinterpret_cast<const bf16*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15});
}

__device__ __forceinline__ unsigned stage_span(const bf16* src, int elems) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return static_cast<unsigned>(align16((a & 15) + static_cast<size_t>(elems) * 2));
}

// glimpse_head's logits of one batch row, regions [r_lo, r_lo + mine): one
// warp a region, its lanes over pairs of joint values (jr: the row's region
// r_lo, in shared or device memory), w at w_s, every glimpse in groups of
// kGroup, a shuffle reduction plus the bias; each logit stored into the
// alpha row of every CTA of the cluster and, rounded, into logits_out
// (row `at0` of [B * R, G])
__device__ __forceinline__ void region_logits(const Params& p, const bf16* jr0, const bf16* w_s,
                                              const float* bias_s, float* alpha_row, int64_t at0,
                                              int r_lo, int mine) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int G = p.G, M = p.M, gp = ceil_div(G, kGroup) * kGroup;
  const bool pairs = M % 2 == 0 && (reinterpret_cast<uintptr_t>(p.joint) & 3) == 0;
  for (int rr = warp; rr < mine; rr += kWarps) {
    const int r = r_lo + rr;
    const bf16* jr = jr0 + static_cast<int64_t>(rr) * M;
    for (int g0 = 0; g0 < G; g0 += kGroup) {
      float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};
      if (pairs) {
#pragma unroll 4
        for (int m2 = lane; m2 < M / 2; m2 += 32) {
          const float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(jr)[m2]);
          const bf16* w0 = w_s + 2 * m2 * G + g0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g0 + g < G) {
              acc[g] += x.x * __bfloat162float(w0[g]);
              acc[g] += x.y * __bfloat162float(w0[G + g]);
            }
          }
        }
      } else {
        for (int m = lane; m < M; m += 32) {
          const float x = __bfloat162float(jr[m]);
          const bf16* w0 = w_s + m * G + g0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g0 + g < G) acc[g] += x * __bfloat162float(w0[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (g0 + g < G) {
          const float l = warp_sum(acc[g]) + bias_s[g0 + g];
          if (lane == 0) {
            float* dst = alpha_row + r * gp + g0 + g;
            if (p.split == 1) {
              *dst = l;
            } else {
              for (int q = 0; q < p.split; ++q) st_cluster(dst, q, l);
            }
            p.logits_out[(at0 + r) * G + g0 + g] = __float2bfloat16(l);
          }
        }
      }
    }
  }
}

// softmax over the regions of alpha [R, gp], one warp a glimpse, in fp32;
// alpha rounded to bf16 (as the weighted sum takes it)
__device__ __forceinline__ void softmax_regions(float* alpha, int R, int G, int gp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float neg_inf = __int_as_float(0xff800000);
  for (int g = warp; g < G; g += kWarps) {
    float* a = alpha + g;
    float mx = neg_inf;
    for (int r = lane; r < R; r += 32) mx = fmaxf(mx, a[r * gp]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < R; r += 32) sum += expf(a[r * gp] - mx);
    const float inv = 1.f / warp_sum(sum);
    for (int r = lane; r < R; r += 32) {
      a[r * gp] = __bfloat162float(__float2bfloat16(expf(a[r * gp] - mx) * inv));
    }
  }
}

// The ring kernel: one CTA (of a cluster of `split`) a batch row. kMode: how
// v (and staged joint and w) reach shared memory: kModeBulk, 1-D bulk copies
// into the ring, each stage on its mbarrier, 4 columns a thread item;
// kModePlain, plain copies into one stage, one column an item.
// kLogitsGiven: read logits [B, R, G] (glimpse_attend) instead of computing
// them from joint, w and bias (glimpse_head, which also writes logits_out).
template <int kMode, bool kLogitsGiven>
__global__ void __launch_bounds__(kThreads) glimpse_kernel(const Params p) {
  constexpr bool kBulk = kMode == kModeBulk;
  constexpr int W = kMode == kModePlain ? 1 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = p.R, G = p.G, D = p.D;
  const int gp = ceil_div(G, kGroup) * kGroup;
  const int dc = D / p.split;
  const int rank = static_cast<int>(blockIdx.x % p.split);  // == %cluster_ctarank
  const int64_t b = blockIdx.x / p.split;                    // this CTA's batch row
  const int d0 = rank * dc;

  const bool staged = !kLogitsGiven && kMode != kModePlain && p.staged;
  const Layout lay = layout(R, p.M, G, dc, p.split, p.chunk, p.stages, staged);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // the ring's stages, then joint's
  float* alpha = reinterpret_cast<float*>(smem + lay.alpha);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);
  const int n_chunks = ceil_div(R, p.chunk);
  const bool resident = p.stages >= n_chunks;
  const size_t stage_elems = static_cast<size_t>(p.chunk) * dc;
  const int n_packs = dc / W;
  const int n_items = (gp / kGroup) * n_packs;
  const int n_passes = ceil_div(n_items, kThreads);
  const int n_loads = resident ? n_chunks : n_passes * n_chunks;
  const bf16* vb = p.v + b * R * D + d0;
  // glimpse_head: this CTA computes the logits of regions [r_lo, r_lo + mine)
  const int nper = ceil_div(R, p.split);
  const int r_lo = rank * nper;
  const int mine = kLogitsGiven ? 0 : max(0, min(R - r_lo, nper));

  // the few values a CTA reads before its math, loaded ahead of every bulk
  // copy so they do not queue behind them: the given logits
  // (glimpse_attend) or the bias (glimpse_head); the first one a thread here
  const int n_pre = kLogitsGiven ? R * G : G;
  const bf16* pre_src = kLogitsGiven ? p.logits_in + b * R * G : p.bias;
  const float pre = tid < n_pre ? __bfloat162float(pre_src[tid]) : 0.f;

  // load number `seq` of the ring (warp 0): chunk seq % n_chunks into stage
  // seq % stages, one bulk copy a region
  auto issue = [&](int seq) {
    const int c = seq % n_chunks, s = seq % p.stages;
    const int r0 = c * p.chunk, nr = min(p.chunk, R - r0);
    if (lane == 0) mbar_expect_tx(full + s, static_cast<unsigned>(nr * dc * 2));
    __syncwarp();
    for (int rr = lane; rr < nr; rr += 32) {
      bulk_load(ring + s * stage_elems + static_cast<size_t>(rr) * dc,
                vb + static_cast<int64_t>(r0 + rr) * D, dc * 2, full + s);
    }
  };
  const bf16* joint_at = kLogitsGiven ? nullptr : p.joint + (b * R + r_lo) * p.M;
  const int jlen = mine * p.M;  // joint elements this CTA reads

  if (kBulk) {
    if (tid == 0) {
      for (int s = 0; s <= p.stages; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {
      if (staged) {  // w and this CTA's joint slice first, on their own barrier
        const unsigned w_bytes = stage_span(p.w, p.M * G);
        const unsigned j_bytes = jlen > 0 ? stage_span(joint_at, jlen) : 0u;
        if (lane == 0) {
          mbar_expect_tx(full + p.stages, w_bytes + j_bytes);
          bulk_load(smem + lay.w, stage_base(p.w), w_bytes, full + p.stages);
          if (j_bytes) bulk_load(smem + lay.joint, stage_base(joint_at), j_bytes, full + p.stages);
        }
        __syncwarp();
      }
      for (int seq = 0; seq < min(p.stages, n_loads); ++seq) issue(seq);
    }
  }

  // alpha's padding glimpses [G, gp) are zero: the weighted sum reads them
  for (int i = tid; i < R * (gp - G); i += kThreads) {
    alpha[(i / (gp - G)) * gp + G + i % (gp - G)] = 0.f;
  }
  for (int i = tid; i < n_pre; i += kThreads) {
    const float x = i == tid ? pre : __bfloat162float(pre_src[i]);
    if (kLogitsGiven) {
      alpha[(i / G) * gp + i % G] = x;
    } else {
      bias_s[i] = x;
    }
  }
  if (!kLogitsGiven && p.split > 1) {
    // every CTA of the cluster has started before any stores into its alpha
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  __syncthreads();

  if (!kLogitsGiven) {
    // joint and w from shared memory where staged, else from device memory
    if (staged) mbar_wait(full + p.stages, 0);
    const bf16* w_s = staged ? reinterpret_cast<const bf16*>(smem + lay.w) + stage_lead(p.w) : p.w;
    const bf16* jr =
        staged ? reinterpret_cast<const bf16*>(smem + lay.joint) + stage_lead(joint_at) : joint_at;
    if (p.split > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    region_logits(p, jr, w_s, bias_s, alpha, b * R, r_lo, mine);
    if (p.split > 1) {
      cluster_sync();  // every CTA's logits in every alpha (a CTA barrier too)
    } else {
      __syncthreads();
    }
  }
  softmax_regions(alpha, R, G, gp);
  __syncthreads();

  // attended[g, d] = sum_r alpha[r, g] * v[r, d]; an item is W columns for
  // one group of kGroup glimpses
  for (int pass = 0; pass < n_passes; ++pass) {
    const int item = pass * kThreads + tid;
    const bool active = item < n_items;
    const int grp = active ? item / n_packs : 0;
    const int col = active ? (item - grp * n_packs) * W : 0;
    float acc[kGroup][W];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int seq = resident ? c : pass * n_chunks + c;
      const int s = seq % p.stages;
      const int r0 = c * p.chunk, nr = min(p.chunk, R - r0);
      if (kBulk) {
        mbar_wait(full + s, (seq / p.stages) & 1);
      } else if (kMode == kModePlain) {
        __syncthreads();  // the stage's readers are done
        for (int i = tid; i < nr * dc; i += kThreads) {
          ring[i] = vb[static_cast<int64_t>(r0 + i / dc) * D + i % dc];
        }
        __syncthreads();
      }
      if (active) {
        const bf16* vs = ring + s * stage_elems + col;
        const float* al = alpha + r0 * gp + grp * kGroup;
        const int live = min(kGroup, G - grp * kGroup);  // glimpses of this group
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          float x[W];
          load_cols<W>(vs + static_cast<size_t>(rr) * dc, x);
          const float4 a4 = *reinterpret_cast<const float4*>(al + rr * gp);
          const float a[kGroup] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (g < live) {
#pragma unroll
              for (int e = 0; e < W; ++e) acc[g][e] += a[g] * x[e];
            }
          }
        }
      }
      if (kBulk && !resident) {
        __syncthreads();  // every thread is done with stage s
        if (warp == 0 && seq + p.stages < n_loads) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(seq + p.stages);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int gg = grp * kGroup + g;
        if (gg < G) store_cols<W>(p.out + (b * G + gg) * D + d0 + col, acc[g]);
      }
    }
  }
}

// The parent design (the one-block-a-row kernel this file held before the
// ring), kept for the shapes where it measured fastest: glimpse_head at a
// large batch with G <= 4 (PERF.md, Findings). One 256-thread block a batch
// row, w in fp32 shared memory, logits one warp a region, the softmax one thread a
// glimpse, then v streamed from device memory in 16-byte loads, each thread
// keeping G x 8 fp32 accumulators; D % 8 != 0 takes scalar loads.
constexpr int kParentMaxG = 4;

// logits[r, g] = joint[r, :] . w[:, g] + bias[g] into alpha_s (fp32) and
// logits_out (bf16): w staged in shared memory, one warp per region
__device__ __forceinline__ void parent_logits(const bf16* __restrict__ jb,
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
    float acc[kParentMaxG] = {0.f, 0.f, 0.f, 0.f};
    const bf16* row = jb + static_cast<int64_t>(r) * M;
    for (int m = lane; m < M; m += 32) {
      const float x = __bfloat162float(row[m]);
#pragma unroll
      for (int g = 0; g < kParentMaxG; ++g) {
        if (g < G) acc[g] += x * w_s[m * G + g];
      }
    }
#pragma unroll
    for (int g = 0; g < kParentMaxG; ++g) {
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
glimpse_parent_kernel(const bf16* __restrict__ joint, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const bf16* __restrict__ logits_in,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    bf16* __restrict__ logits_out, int R, int M, int G, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);         // [M, G] (glimpse_head only)
  float* alpha_s = w_s + (kLogitsGiven ? 0 : M * G);   // [R, G]: logits, then alpha
  const int64_t b = blockIdx.x;
  const bf16* vb = v + b * R * D;

  if (kLogitsGiven) {
    const bf16* lb = logits_in + b * R * G;
    for (int i = threadIdx.x; i < R * G; i += kThreads) alpha_s[i] = __bfloat162float(lb[i]);
  } else {
    parent_logits(joint + b * R * M, w, bias, w_s, alpha_s, logits_out + b * R * G, R, M, G);
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
      float acc[kParentMaxG][8];
#pragma unroll
      for (int g = 0; g < kParentMaxG; ++g)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[g][k] = 0.f;
      for (int r = 0; r < R; ++r) {
        Pack8 x;
        x.u = *reinterpret_cast<const uint4*>(vb + static_cast<int64_t>(r) * D + d);
#pragma unroll
        for (int g = 0; g < kParentMaxG; ++g) {
          if (g < G) {
            const float a = alpha_s[r * G + g];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[g][k] += a * __bfloat162float(x.h[k]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kParentMaxG; ++g) {
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
      float acc[kParentMaxG] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < R; ++r) {
        const float x = __bfloat162float(vb[static_cast<int64_t>(r) * D + d]);
#pragma unroll
        for (int g = 0; g < kParentMaxG; ++g) {
          if (g < G) acc[g] += alpha_s[r * G + g] * x;
        }
      }
#pragma unroll
      for (int g = 0; g < kParentMaxG; ++g) {
        if (g < G) ob[static_cast<int64_t>(g) * D + d] = __float2bfloat16(acc[g]);
      }
    }
  }
}

// ------------------------------------------------------------- float32

constexpr int kF32Group = 4;  // glimpses a thread of the f32 kernel accumulates at once

// the f32 kernel's shared memory: alpha [R, G] (fp32), then w [M, G] where
// staged
__host__ __device__ inline size_t f32_smem(int R, int M, int G, bool staged) {
  return static_cast<size_t>(R) * G * 4 + (staged ? static_cast<size_t>(M) * G * 4 : 0);
}

template <bool kLogitsGiven, bool kVec>
__global__ void __launch_bounds__(kThreads)
glimpse_f32_kernel(const float* __restrict__ joint, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ logits_in,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ logits_out, int R, int M, int G, int D, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* alpha = reinterpret_cast<float*>(smem);  // [R, G]: logits, then alpha
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.x;
  const float* vb = v + b * R * D;

  if (kLogitsGiven) {
    const float* lb = logits_in + b * R * G;
    for (int i = tid; i < R * G; i += kThreads) alpha[i] = lb[i];
  } else {
    // w in shared memory where it fits, else from device memory
    const float* w_src = w;
    if (staged) {
      float* w_s = alpha + R * G;
      for (int i = tid; i < M * G; i += kThreads) w_s[i] = w[i];
      w_src = w_s;
    }
    __syncthreads();
    const float* jb = joint + b * R * M;
    float* lo = logits_out + b * R * G;
    for (int r = warp; r < R; r += kWarps) {
      const float* row = jb + static_cast<int64_t>(r) * M;
      for (int g0 = 0; g0 < G; g0 += kF32Group) {
        float acc[kF32Group] = {0.f, 0.f, 0.f, 0.f};
        for (int m = lane; m < M; m += 32) {
          const float x = row[m];
          const float* w0 = w_src + static_cast<int64_t>(m) * G + g0;
#pragma unroll
          for (int g = 0; g < kF32Group; ++g) {
            if (g0 + g < G) acc[g] += x * w0[g];
          }
        }
#pragma unroll
        for (int g = 0; g < kF32Group; ++g) {
          if (g0 + g < G) {
            const float l = warp_sum(acc[g]) + bias[g0 + g];
            if (lane == 0) {
              alpha[r * G + g0 + g] = l;
              lo[r * G + g0 + g] = l;
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // softmax over the regions, one warp a glimpse, in place
  const float neg_inf = __int_as_float(0xff800000);
  for (int g = warp; g < G; g += kWarps) {
    float mx = neg_inf;
    for (int r = lane; r < R; r += 32) mx = fmaxf(mx, alpha[r * G + g]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < R; r += 32) sum += expf(alpha[r * G + g] - mx);
    const float inv = 1.f / warp_sum(sum);
    for (int r = lane; r < R; r += 32) alpha[r * G + g] = expf(alpha[r * G + g] - mx) * inv;
  }
  __syncthreads();

  // attended[g, d] = sum_r alpha[r, g] * v[r, d]; an item is W columns for
  // one group of kF32Group glimpses
  constexpr int W = kVec ? 4 : 1;
  const int n_packs = D / W;
  const int n_items = ceil_div(G, kF32Group) * n_packs;
  float* ob = out + b * G * D;
  for (int item = tid; item < n_items; item += kThreads) {
    const int grp = item / n_packs;
    const int col = (item - grp * n_packs) * W;
    const int g0 = grp * kF32Group;
    float acc[kF32Group][W];
#pragma unroll
    for (int g = 0; g < kF32Group; ++g)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] = 0.f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float x[W];
      if constexpr (kVec) {
        const float4 q = *reinterpret_cast<const float4*>(vb + static_cast<int64_t>(r) * D + col);
        x[0] = q.x;
        x[1] = q.y;
        x[2] = q.z;
        x[3] = q.w;
      } else {
        x[0] = vb[static_cast<int64_t>(r) * D + col];
      }
#pragma unroll
      for (int g = 0; g < kF32Group; ++g) {
        if (g0 + g < G) {
          const float a = alpha[r * G + g0 + g];
#pragma unroll
          for (int e = 0; e < W; ++e) acc[g][e] += a * x[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kF32Group; ++g) {
      if (g0 + g < G) {
        float* o = ob + static_cast<int64_t>(g0 + g) * D + col;
        if constexpr (kVec) {
          *reinterpret_cast<float4*>(o) = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        } else {
          *o = acc[g][0];
        }
      }
    }
  }
}



// ---------------------------------------------------------------- split

// The split design (both types; the entry vqa_glimpse_split): for the
// shapes whose alpha [R, G] does not fit in a block's shared memory (bf16
// with one region of the ring beside it; float32 alone), e.g. R=196 with
// G=512, or R past ~14,500 with 4 glimpses. A block owns (batch row, group
// of `gc` glimpses, chunk of `chunk` regions) and holds only alpha [chunk,
// gc] in fp32:
//   - the logits of its regions and glimpses, one warp a region, lanes over
//     joint, glimpses in groups of 4, w read from device memory (glimpse_head,
//     which writes each logit once, so logits_out is exact), or the given
//     logits (glimpse_attend);
//   - the softmax over its regions, one warp a glimpse;
//   - the weighted sum, a thread 4 columns (16-byte float32 or 8-byte bf16
//     loads of v from device memory; one column where D % 4 != 0 or a
//     pointer is off 16 bytes) for a group of 4 glimpses.
// With one chunk (every region in the block) alpha is exact and rounded to
// v's type before the weighted sum, as the other designs do. With several,
// each block writes its chunk's unnormalised fp32 partial [B G, C, D] and
// each glimpse's (max, sum of exp) [B G, C, 2], and lse_merge.cuh's kernel
// merges them (alpha unrounded there). What bounds it: v, read once a group
// of 4 glimpses, and at G=512 the logits' 51 M multiply-adds a row on the
// CUDA cores; nothing on the tensor cores (a simple design for shapes no
// YAML reaches).

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float round_to(bf16*, float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float*, float x) { return x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

__device__ __forceinline__ void load4v(const bf16* p, float (&x)[4]) { load_cols<4>(p, x); }
__device__ __forceinline__ void load4v(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

template <typename T>
struct SplitParams {
  const T* joint;      // [B, R, M] (glimpse_head)
  const T* w;          // [M, G]
  const T* bias;       // [G]
  const T* logits_in;  // [B, R, G] (glimpse_attend)
  const T* v;          // [B, R, D]
  T* out;              // [B, G, D]
  T* logits_out;       // [B, R, G] (glimpse_head)
  float* part;         // [B G, chunks, D] (chunks > 1)
  float* stats;        // [B G, chunks, 2] (chunks > 1)
  int B, R, M, G, D;
  int gc;     // glimpses a block
  int chunk;  // regions a block
};

template <typename T, bool kLogitsGiven, bool kVec>
__global__ void __launch_bounds__(kThreads) glimpse_split_kernel(const SplitParams<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* alpha = reinterpret_cast<float*>(smem);  // [chunk, gc]: logits, then alpha
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = p.R, G = p.G, D = p.D, M = p.M, gc = p.gc;
  const int n_chunks = ceil_div(R, p.chunk), n_groups = ceil_div(G, gc);
  const int c = static_cast<int>(blockIdx.x % n_chunks);
  const int grp = static_cast<int>((blockIdx.x / n_chunks) % n_groups);
  const int64_t b = blockIdx.x / (static_cast<int64_t>(n_chunks) * n_groups);
  const int g0 = grp * gc, ng = min(gc, G - g0);
  const int r0 = c * p.chunk, nr = min(p.chunk, R - r0);

  if (kLogitsGiven) {
    const T* lb = p.logits_in + (b * R + r0) * G + g0;
    for (int i = tid; i < nr * ng; i += kThreads) {
      alpha[(i / ng) * gc + i % ng] = to_f(lb[static_cast<int64_t>(i / ng) * G + i % ng]);
    }
  } else {
    for (int rr = warp; rr < nr; rr += kWarps) {
      const T* jr = p.joint + (b * R + r0 + rr) * M;
      T* lo = p.logits_out + (b * R + r0 + rr) * G + g0;
      for (int q0 = 0; q0 < ng; q0 += kGroup) {
        float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};
        for (int m = lane; m < M; m += 32) {
          const float x = to_f(jr[m]);
          const T* w0 = p.w + static_cast<int64_t>(m) * G + g0 + q0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (q0 + g < ng) acc[g] += x * to_f(w0[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (q0 + g < ng) {
            const float l = warp_sum(acc[g]) + to_f(p.bias[g0 + q0 + g]);
            if (lane == 0) {
              alpha[rr * gc + q0 + g] = l;
              put(lo + q0 + g, l);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // softmax over this block's regions, one warp a glimpse: exact (and
  // rounded to T) with one chunk; else unnormalised, with (max, sum)
  const float neg_inf = __int_as_float(0xff800000);
  for (int g = warp; g < ng; g += kWarps) {
    float* a = alpha + g;
    float mx = neg_inf;
    for (int rr = lane; rr < nr; rr += 32) mx = fmaxf(mx, a[rr * gc]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int rr = lane; rr < nr; rr += 32) sum += expf(a[rr * gc] - mx);
    sum = warp_sum(sum);
    if (n_chunks == 1) {
      const float inv = 1.f / sum;
      for (int rr = lane; rr < nr; rr += 32) {
        a[rr * gc] = round_to(p.out, expf(a[rr * gc] - mx) * inv);
      }
    } else {
      for (int rr = lane; rr < nr; rr += 32) a[rr * gc] = expf(a[rr * gc] - mx);
      if (lane == 0) {
        *reinterpret_cast<float2*>(p.stats + ((b * G + g0 + g) * n_chunks + c) * 2) =
            make_float2(mx, sum);
      }
    }
  }
  __syncthreads();

  // the weighted sum: an item is W columns for a group of kGroup glimpses
  constexpr int W = kVec ? 4 : 1;
  const int n_packs = D / W;
  const int n_items = ceil_div(ng, kGroup) * n_packs;
  const T* vb = p.v + (b * R + r0) * D;
  for (int item = tid; item < n_items; item += kThreads) {
    const int q0 = (item / n_packs) * kGroup;
    const int col = (item % n_packs) * W;
    float acc[kGroup][W];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < nr; ++rr) {
      float x[W];
      if constexpr (kVec) {
        load4v(vb + static_cast<int64_t>(rr) * D + col, x);
      } else {
        x[0] = to_f(vb[static_cast<int64_t>(rr) * D + col]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (q0 + g < ng) {
          const float a = alpha[rr * gc + q0 + g];
#pragma unroll
          for (int e = 0; e < W; ++e) acc[g][e] += a * x[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int gg = g0 + q0 + g;
      if (q0 + g < ng) {
        if (n_chunks == 1) {
          T* o = p.out + (b * G + gg) * D + col;
#pragma unroll
          for (int e = 0; e < W; ++e) put(o + e, acc[g][e]);
        } else {
          float* o = p.part + ((b * G + gg) * n_chunks + c) * D + col;
#pragma unroll
          for (int e = 0; e < W; ++e) o[e] = acc[g][e];
        }
      }
    }
  }
}


// the shared memory a block may opt into on the current card, asked once a
// device (launches of a few microseconds feel a host call each)
int smem_optin(size_t* bytes) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || cached[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) cached[dev] = optin;
    *bytes = static_cast<size_t>(optin);
    return 0;
  }
  *bytes = static_cast<size_t>(cached[dev]);
  return 0;
}

template <bool kLogitsGiven>
cudaError_t launch_parent(const Params& p, cudaStream_t s) {
  if (p.G > kParentMaxG || p.split != 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kLogitsGiven ? p.R : p.M + p.R) * p.G * sizeof(float);
  size_t optin = 0;
  cudaError_t err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  const bool vec = p.D % 8 == 0 && (reinterpret_cast<uintptr_t>(p.v) |
                                    reinterpret_cast<uintptr_t>(p.out)) % 16 == 0;
  auto kernel = vec ? glimpse_parent_kernel<true, kLogitsGiven>
                    : glimpse_parent_kernel<false, kLogitsGiven>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.B, kThreads, smem, s>>>(p.joint, p.w, p.bias, p.logits_in, p.v, p.out,
                                     p.logits_out, p.R, p.M, p.G, p.D);
  return cudaGetLastError();
}

template <bool kLogitsGiven>
cudaError_t launch(const Params& p, int mode, cudaStream_t s) {
  if (p.B <= 0) return cudaSuccess;
  if (p.R < 1 || p.G < 1 || p.D < 1 || p.M < (kLogitsGiven ? 0 : 1) || p.chunk < 1 ||
      p.stages < 1 || p.split < 1 || p.split > kMaxSplit || p.D % p.split != 0)
    return cudaErrorInvalidValue;
  if (mode == kModeParent) return launch_parent<kLogitsGiven>(p, s);
  const int dc = p.D / p.split;
  if (mode == kModeBulk) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.out);
    if (dc % 8 != 0 || ptrs % 16 != 0) return cudaErrorInvalidValue;
  } else if (mode != kModePlain || p.split != 1 || p.stages != 1) {
    return cudaErrorInvalidValue;
  }
  const bool staged = mode == kModeBulk && p.staged;
  const size_t smem = layout(p.R, p.M, p.G, dc, p.split, p.chunk, p.stages, staged).total;
  size_t optin = 0;
  cudaError_t err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  auto kernel = mode == kModeBulk ? glimpse_kernel<kModeBulk, kLogitsGiven>
                                  : glimpse_kernel<kModePlain, kLogitsGiven>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.B * p.split));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;  // a cluster only where CTAs share a row
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


template <bool kLogitsGiven>
cudaError_t launch_f32(const float* joint, const float* w, const float* bias,
                       const float* logits_in, const float* v, float* out, float* logits_out,
                       int B, int R, int M, int G, int D, int staged, cudaStream_t s) {
  if (B <= 0) return cudaSuccess;
  if (R < 1 || G < 1 || D < 1 || M < (kLogitsGiven ? 0 : 1)) return cudaErrorInvalidValue;
  const bool w_staged = !kLogitsGiven && staged;
  const size_t smem = f32_smem(R, M, G, w_staged);
  size_t optin = 0;
  cudaError_t err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(v) |
                                  reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = vec ? glimpse_f32_kernel<kLogitsGiven, true>
                    : glimpse_f32_kernel<kLogitsGiven, false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, smem, s>>>(joint, w, bias, logits_in, v, out, logits_out, R, M, G, D,
                                   w_staged ? 1 : 0);
  return cudaGetLastError();
}

// the split design's shared memory: alpha [chunk, gc] (fp32)
inline size_t split_smem(int chunk, int gc) { return static_cast<size_t>(chunk) * gc * 4; }

template <typename T>
cudaError_t launch_split(const SplitParams<T>& p, int chunks, cudaStream_t s) {
  if (p.B <= 0) return cudaSuccess;
  const bool given = p.logits_in != nullptr;
  if (p.R < 1 || p.G < 1 || p.D < 1 || p.M < (given ? 0 : 1) || p.gc < 1 || p.gc > p.G ||
      chunks < 1 || chunks > p.R || chunks > lse::kMaxMergeChunks)
    return cudaErrorInvalidValue;
  if (p.chunk != ceil_div(p.R, chunks) || ceil_div(p.R, p.chunk) != chunks)
    return cudaErrorInvalidValue;
  if (chunks > 1 && (p.part == nullptr || p.stats == nullptr)) return cudaErrorInvalidValue;
  const long long ctas =
      static_cast<long long>(p.B) * ceil_div(p.G, p.gc) * static_cast<long long>(chunks);
  if (ctas >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = split_smem(p.chunk, p.gc);
  size_t optin = 0;
  cudaError_t err = static_cast<cudaError_t>(smem_optin(&optin));
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.out) |
                         reinterpret_cast<uintptr_t>(p.part);
  const bool vec = p.D % 4 == 0 && ptrs % 16 == 0;
  auto kernel = given ? (vec ? glimpse_split_kernel<T, true, true>
                             : glimpse_split_kernel<T, true, false>)
                      : (vec ? glimpse_split_kernel<T, false, true>
                             : glimpse_split_kernel<T, false, false>);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return lse::merge<T>(p.part, p.stats, p.out, static_cast<int64_t>(p.B) * p.G, chunks, p.D, s);
}

template <typename T>
int split_entry(const void* joint, const void* w, const void* bias, const void* logits_in,
                const void* v, void* out, void* logits_out, void* part, void* stats, int B, int R,
                int M, int G, int D, int gc, int chunks, cudaStream_t s) {
  const SplitParams<T> p{static_cast<const T*>(joint), static_cast<const T*>(w),
                         static_cast<const T*>(bias), static_cast<const T*>(logits_in),
                         static_cast<const T*>(v), static_cast<T*>(out),
                         static_cast<T*>(logits_out), static_cast<float*>(part),
                         static_cast<float*>(stats), B, R, M, G, D, gc,
                         chunks >= 1 ? ceil_div(R, chunks) : 0};
  return static_cast<int>(launch_split<T>(p, chunks, s));
}

}  // namespace

// glimpse_head on `stream`, with the schedule ops/attention.py::glimpse_plan
// chose, `mode`: 2 the parent's one-block-a-row kernel (G <= 4; the other
// schedule arguments 1); 1 the bulk-copy ring: one CTA a batch row, its
// D split over a cluster of `split` CTAs, `stages` stages of `chunk`
// regions, `staged` w and joint through shared memory (D / split % 8 == 0,
// v and out on 16 bytes); 0 the generic path (split = stages = 1, nothing
// staged). Returns the launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_head(const void* joint, const void* w, const void* bias, const void* v,
                                void* out, void* logits, int B, int R, int M, int G, int D,
                                int split, int chunk, int stages, int staged, int mode,
                                void* stream) {
  const Params p{static_cast<const bf16*>(joint), static_cast<const bf16*>(w),
                 static_cast<const bf16*>(bias), nullptr, static_cast<const bf16*>(v),
                 static_cast<bf16*>(out), static_cast<bf16*>(logits), B, R, M, G, D, split,
                 chunk, stages, staged};
  return static_cast<int>(launch<false>(p, mode, static_cast<cudaStream_t>(stream)));
}

// glimpse_attend, the logits-given entry, with the same schedule arguments.
// Returns the launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_attend(const void* logits, const void* v, void* out, int B, int R,
                                  int G, int D, int split, int chunk, int stages,
                                  int mode, void* stream) {
  const Params p{nullptr, nullptr, nullptr, static_cast<const bf16*>(logits),
                 static_cast<const bf16*>(v), static_cast<bf16*>(out), nullptr, B, R, 0, G, D,
                 split, chunk, stages, 0};
  return static_cast<int>(launch<true>(p, mode, static_cast<cudaStream_t>(stream)));
}

// glimpse_head in float32 (every operand and output float32) on `stream`:
// one block a batch row; `staged` (ops/attention.py::glimpse_plan) copies w
// into shared memory beside alpha. Returns the launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_head_f32(const void* joint, const void* w, const void* bias,
                                    const void* v, void* out, void* logits, int B, int R, int M,
                                    int G, int D, int staged, void* stream) {
  return static_cast<int>(launch_f32<false>(
      static_cast<const float*>(joint), static_cast<const float*>(w),
      static_cast<const float*>(bias), nullptr, static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(logits), B, R, M, G, D, staged,
      static_cast<cudaStream_t>(stream)));
}

// glimpse_attend in float32, the logits-given entry of the same kernel.
// Returns the launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_attend_f32(const void* logits, const void* v, void* out, int B, int R,
                                      int G, int D, void* stream) {
  return static_cast<int>(launch_f32<true>(
      nullptr, nullptr, nullptr, static_cast<const float*>(logits), static_cast<const float*>(v),
      static_cast<float*>(out), nullptr, B, R, 0, G, D, 0, static_cast<cudaStream_t>(stream)));
}

// The split design (ops/attention.py::glimpse_plan, copy "split"), in bf16
// (`elem` 2) or float32 (`elem` 4) on `stream`: glimpse_head where
// `logits_in` is null (joint, w, bias given; logits written), else
// glimpse_attend (joint, w, bias and logits_out unused). `gc` glimpses and
// ceil(R / chunks) regions a block; with chunks > 1, part [B G, chunks, D]
// and stats [B G, chunks, 2] (fp32 scratch the caller allocates) take the
// chunks' partials, merged into out by lse_merge.cuh. Returns the first
// failing launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_split(const void* joint, const void* w, const void* bias,
                                 const void* logits_in, const void* v, void* out,
                                 void* logits_out, void* part, void* stats, int B, int R, int M,
                                 int G, int D, int gc, int chunks, int elem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (elem == 2)
    return split_entry<bf16>(joint, w, bias, logits_in, v, out, logits_out, part, stats, B, R, M,
                             G, D, gc, chunks, s);
  if (elem == 4)
    return split_entry<float>(joint, w, bias, logits_in, v, out, logits_out, part, stats, B, R,
                              M, G, D, gc, chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory a block of this card may opt into (bytes), into *bytes.
// Returns a cudaError_t.
extern "C" int vqa_smem_optin(long long* bytes) {
  size_t optin = 0;
  const int err = smem_optin(&optin);
  *bytes = static_cast<long long>(optin);
  return err;
}
