// glimpse_head / glimpse_attend's "tc" design (bf16): the glimpse kernels
// past alpha [R, G] in shared memory, their products on the tensor cores.
//
//   glimpse_head:   joint [B, R, M], w [M, G], b [G], v [B, R, D]
//     logits[b, r, g]   = sum_m joint[b, r, m] w[m, g] + b[g]   (fp32)
//   glimpse_attend: logits [B, R, G] given
//   both: alpha[b, :, g]    = softmax over the R regions of logits[b, :, g]
//         attended[b, g, d] = sum_r alpha[b, r, g] v[b, r, d]
//
// Replaces vqa_tpu/ops/attention.py::_head_pallas (_head_kernel) and
// _pallas_fwd (_kernel) at the shapes whose alpha [R, G] does not fit in a
// block's shared memory beside a stage of v (R=3136 with 24 glimpses over
// the 56 x 56 grid of a 1792-pixel extract; R=196 with G=512; R=16,384),
// where csrc/glimpse_head.cu's split design ran before. It keeps the Pallas
// kernels' numerics: the logits in fp32 (plus the bias), the softmax in
// fp32 from the unrounded logits, alpha rounded once to bf16, the weighted
// sum accumulated in fp32, each output rounded once (logits_out from the
// fp32 logits).
//
// What bounds it on the H100: bytes. At B=64, R=3136, M=510, G=24, D=2048
// v is 822 MB and joint 205 MB, against 24 GFLOP of products: 0.31 ms at
// 3.35 TB/s. The split design read v once per group of 4 glimpses from
// device memory (six times at G=24), one serial chain a thread. Here v is
// read once, by TMA, and both products run on the tensor cores.
//
// Two kernels on one stream (and, where the regions are split into chunks,
// a third that adds the chunks' partials):
//
// 1. logits (glimpse_tc_logits_kernel, 256 threads): a CTA stages w^T [ln, M] once
//    (ln glimpses, up to 64; zero past M and past G), then walks tiles of
//    `rows` regions of one batch row (64; fewer, and fewer glimpses a CTA,
//    where M is wide). joint's rows are M * 2 bytes (1020 at M=510: no
//    16-byte rows, so no 2-D map, no ldmatrix), but a tile of consecutive
//    rows is contiguous: one 1-D bulk copy brings it, from the 16-byte
//    granule at or below its first byte. The products on mma.sync
//    m16n8k16, A fragments by 4-byte shared loads (M even; else 2-byte
//    loads), mma row i of a warp's 16 taking tile row 4 i + its row group,
//    so that the 255-word row stride spreads the lanes over the banks; the
//    two warps of a row group take the two halves of M (a latency-bound
//    chain of k16 steps halved), their sums added in order. The epilogue
//    (the next tile's copy already in flight) writes logits_out (bf16), the
//    fp32 logits into scratch lg [B, groups, rpad, kn] and each (row,
//    glimpse, tile)'s (max, sum of exp) into stats [B, groups kn, tiles, 2]
//    (csrc/lse_merge.cuh's convention), ten threads a glimpse over runs of
//    the rows merged in order. glimpse_attend runs the same kernel on the
//    given logits, without the products.
// 2. weighted sum (glimpse_tc_sum_kernel<kn>, 288 threads): a CTA owns a batch row,
//    a group of kn glimpses (wgmma's N: 8, 16, 24, 32, 64 or 128), 128
//    columns of d and, where B x groups x D / 128 CTAs leave SMs idle, a
//    chunk of the regions. Its consumers first merge the row's tile
//    statistics into (m, l) a glimpse, in tile order. A producer warp keeps
//    a ring of stages in flight on mbarriers: v's two boxes [64 regions x
//    64 columns] (a 3-D map, 128-byte swizzle, zero past the row's R) and
//    the stage's fp32 logits (a 1-D bulk copy of lg). Two consumer
//    warpgroups write alpha^T [kn, 64] = bf16(exp(logit - m) / l) into the
//    stage (K-major, 128-byte swizzle; zero past G and past R, set by index:
//    exp of the scratch past R is never taken), then each runs
//    out^T [64 columns, kn] += v^T alpha as wgmma m64n{kn}k16 (A = v's box,
//    MN-major: the transpose that 16-bit types allow; B = alpha^T), the sum
//    in fp32 registers. alpha is normalised before the sum, so region chunks
//    need no rescaling: each writes an fp32 partial [chunk, B, G, D] and a
//    third kernel adds them in chunk order.
// No atomics: every sum in a fixed order, so two calls give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLogitThreads = 256;         // the logits kernel: eight warps
constexpr int kLogitWarps = kLogitThreads / 32;
constexpr int kConsumers = 256;            // the weighted sum: two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStage = 64;                 // regions a stage of the weighted sum
constexpr int kCols = 128;                 // columns of d a weighted-sum CTA
constexpr int kVBox = kStage * 128;        // v's box: 64 regions x 64 columns, 8 KB
constexpr int kMaxLn = 64;                 // glimpses a logits CTA

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

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

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// generic-proxy accesses of shared memory ordered before the async proxy's
// (a bulk copy's writes, wgmma's reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// the box of `map` at (c0, c1, c2) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the consumer warps of the weighted sum, without the producer
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// c += A (16x16, row-major fragments) B (16x8, column fragments), bf16 in, fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 columns of d x 16 regions: v's box, MN-major, tnsp-a 1) *
// B (16 regions x kn glimpses: alpha^T's tile, K-major), bf16 in, fp32
// accumulate; one specialisation a width kn
template <int kN>
__device__ void wgmma_vt(float (&d)[kN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_vt<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_vt<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_vt<24>(float (&d)[12], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_vt<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_vt<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_vt<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// ------------------------------------------------------------- the kernels

struct TcParams {
  const bf16* joint;      // [B, R, M] (glimpse_head)
  const bf16* w;          // [M, G]
  const bf16* bias;       // [G]
  const bf16* logits_in;  // [B, R, G] (glimpse_attend)
  bf16* logits_out;       // [B, R, G] (glimpse_head)
  float* lg;              // [B, groups, rpad, kn] the fp32 logits
  float* stats;           // [B, groups kn, tiles, 2] each tile's (max, sum of exp)
  int B, R, M, G;
  int kn;      // glimpses a group: the weighted sum's N
  int groups;  // ceil(G / kn)
  int rows;    // regions a logits tile: 64, 32 or 16
  int ln;      // glimpses a logits CTA: a multiple of 8 dividing kn, up to 64
  int rpad;    // R rounded up to kStage: lg's rows a group
};

// the logits kernel's shared memory: its barrier; the bias of its ln
// glimpses (fp32); the statistics' partials (kLogitThreads pairs); P [8 /
// rgs, rows, ln] fp32 (each K part's products of a tile, then the tile's
// logits in part 0; rgs = rows / 16, so 128 rows in all); and for
// glimpse_head w^T [ln, ldw] bf16 (ldw = M rounded up to 16, plus 8: a row
// stride whose B-fragment loads spread over the banks) and the joint tile
// (rows x M bf16 and up to 16 bytes of lead)
struct LogitsLayout {
  size_t bias, red, l, wt, joint, total;
};

__host__ __device__ inline int w_ld(int M) { return ceil_div(M, 16) * 16 + 8; }

__host__ __device__ inline LogitsLayout logits_layout(int rows, int ln, int M, bool given) {
  LogitsLayout s;
  s.bias = 16;
  s.red = s.bias + align16(static_cast<size_t>(ln) * 4);
  s.l = s.red + static_cast<size_t>(kLogitThreads) * 8;
  s.wt = s.l + static_cast<size_t>(kLogitWarps) * 16 * ln * 4;
  s.joint = s.wt + (given ? 0 : static_cast<size_t>(ln) * w_ld(M) * 2);
  s.total = s.joint + (given ? 0 : align16(static_cast<size_t>(rows) * M * 2 + 32));
  return s;
}

// joint[row][k], joint[row][k + 1] as a bf16 pair (k even), zero past M;
// kPair4: the pair is one 4-byte word (M even, joint on 4 bytes). Plain
// loads, so that the compiler schedules them ahead of the products
template <bool kPair4>
__device__ __forceinline__ uint32_t a_pair(const unsigned char* row, int k, int M) {
  if constexpr (kPair4) {
    return k < M ? *reinterpret_cast<const uint32_t*>(row + 2 * k) : 0u;
  } else {
    const uint32_t lo = k < M ? *reinterpret_cast<const unsigned short*>(row + 2 * k) : 0u;
    const uint32_t hi = k + 1 < M ? *reinterpret_cast<const unsigned short*>(row + 2 * k + 2) : 0u;
    return lo | (hi << 16);
  }
}

// logits: CTA (glimpse tile gt, slot) walks the region tiles slot,
// slot + slots, ... (tile t: batch row t / rtiles, regions (t % rtiles) rows..)
// for the glimpse columns gt ln.. of the padded groups
template <bool kGiven, bool kPair4>
__global__ void __launch_bounds__(kLogitThreads)
glimpse_tc_logits_kernel(const TcParams p, int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LogitsLayout lay = logits_layout(p.rows, p.ln, p.M, kGiven);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* L = reinterpret_cast<float*>(smem + lay.l);
  bf16* wt = reinterpret_cast<bf16*>(smem + lay.wt);
  unsigned char* jt = smem + lay.joint;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const int R = p.R, M = p.M, G = p.G, rows = p.rows, ln = p.ln, kn = p.kn;
  const int n_gt = p.groups * kn / ln;
  const int gt = static_cast<int>(blockIdx.x % n_gt);
  const int slot = static_cast<int>(blockIdx.x / n_gt);
  const int c0 = gt * ln;                         // the CTA's first glimpse column
  const int grp = c0 / kn, nn0 = c0 % kn;         // its group, and its column there
  const int rtiles = ceil_div(R, rows);
  const int tiles = p.B * rtiles;                 // below 2^31 (the launcher checks)
  const int gtot = p.groups * kn;
  const int ldw = w_ld(M);

  // the copy of tile t's joint rows: one bulk copy from the 16-byte granule
  // at or below its first byte (lead bytes before it), up to the granule
  // holding its last; the bytes read past either end share a granule with
  // the tile, so no copy reads outside joint's pages
  auto copy_tile = [&](int t) {
    const int b = t / rtiles, r0 = (t % rtiles) * rows;
    const int nr = min(rows, R - r0);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        p.joint + (static_cast<int64_t>(b) * R + r0) * M);
    const uintptr_t lead = reinterpret_cast<uintptr_t>(src) & 15;
    const unsigned bytes = static_cast<unsigned>(align16(lead + static_cast<size_t>(nr) * M * 2));
    fence_async_smem();
    mbar_expect_tx(bar, bytes);
    bulk_load(jt, src - lead, bytes, bar);
  };

  for (int n = tid; n < ln; n += kLogitThreads) {
    bias_s[n] = !kGiven && c0 + n < G ? __bfloat162float(p.bias[c0 + n]) : 0.f;
  }
  if constexpr (!kGiven) {
    if (tid == 0) {
      mbar_init(bar, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0 && slot < tiles) copy_tile(slot);
    // w^T, zero past M and past G (n fastest: consecutive lanes read along
    // a row of w)
    for (int i = tid; i < ln * ldw; i += kLogitThreads) {
      const int k = i / ln, n = i % ln, col = c0 + n;
      wt[n * ldw + k] = k < M && col < G ? p.w[static_cast<int64_t>(k) * G + col]
                                         : __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // the products: warp w takes row group w % rgs (mma row i: tile row
  // i rgs + w % rgs) and K part w / rgs of the 8 / rgs parts (k16 steps in
  // runs), every n-tile; each part's products go to its own P slice, added
  // in part order after them
  const int rgs = rows / 16, rg = warp % rgs, kparts = kLogitWarps / rgs, kp = warp / rgs;
  const int nt = ln / 8, n_k = ceil_div(M, 16), per = ceil_div(n_k, kparts);
  const int ra = g * rgs + rg, rb = (g + 8) * rgs + rg;  // this lane's two A rows
  float* part = L + kp * rows * ln;
  // the statistics: `parts` threads a glimpse, each a run of the rows
  const int parts = kLogitThreads / ln, sn = tid % ln, sp = tid / ln;
  unsigned phase = 0;
  for (int t = slot; t < tiles; t += slots) {
    const int b = t / rtiles, rt = t % rtiles;
    const int r0 = rt * rows, nr = min(rows, R - r0);
    if constexpr (!kGiven) {
      mbar_wait(bar, phase);
      phase ^= 1;
      const uintptr_t lead = reinterpret_cast<uintptr_t>(p.joint + (static_cast<int64_t>(b) * R +
                                                                    r0) * M) & 15;
      const unsigned char* row_a = jt + lead + static_cast<size_t>(ra) * M * 2;
      const unsigned char* row_b = jt + lead + static_cast<size_t>(rb) * M * 2;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const int k_end = min(n_k, (kp + 1) * per) * 16;
#pragma unroll 2
      for (int k0 = kp * per * 16; k0 < k_end; k0 += 16) {
        const int k = k0 + 2 * t4;
        const uint32_t a[4] = {a_pair<kPair4>(row_a, k, M), a_pair<kPair4>(row_b, k, M),
                               a_pair<kPair4>(row_a, k + 8, M), a_pair<kPair4>(row_b, k + 8, M)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            const uint32_t* wn = reinterpret_cast<const uint32_t*>(wt + (j * 8 + g) * ldw + k);
            mma_bf16(acc[j], a, wn[0], wn[4]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const int n = j * 8 + 2 * t4;
          *reinterpret_cast<float2*>(part + ra * ln + n) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(part + rb * ln + n) = make_float2(acc[j][2], acc[j][3]);
        }
      }
      __syncthreads();  // every part written; the joint tile read
      if (tid == 0 && t + slots < tiles) copy_tile(t + slots);
      // the logits: the parts added in part order, then the bias (Pallas:
      // dot, then + b, in fp32), into part 0
      for (int i = tid; i < rows * ln; i += kLogitThreads) {
        float x = L[i];
        for (int q = 1; q < kparts; ++q) x += L[q * rows * ln + i];
        L[i] = x + bias_s[i % ln];
      }
    } else {
      for (int i = tid; i < rows * ln; i += kLogitThreads) {
        const int rr = i / ln, n = i % ln, col = c0 + n;
        L[i] = rr < nr && col < G
                   ? __bfloat162float(p.logits_in[(static_cast<int64_t>(b) * R + r0 + rr) * G + col])
                   : 0.f;
      }
    }
    __syncthreads();

    // the fp32 logits into lg (rows below R; ln floats a row, 16-byte pieces)
    float* lrow = p.lg + ((static_cast<int64_t>(b) * p.groups + grp) * p.rpad + r0) * kn + nn0;
    for (int i = tid; i < nr * (ln / 4); i += kLogitThreads) {
      const int rr = i / (ln / 4), q = i % (ln / 4);
      *reinterpret_cast<float4*>(lrow + static_cast<int64_t>(rr) * kn + 4 * q) =
          *reinterpret_cast<const float4*>(L + rr * ln + 4 * q);
    }
    if constexpr (!kGiven) {  // logits_out, rounded once from the fp32 logits
      for (int i = tid; i < nr * ln; i += kLogitThreads) {
        const int rr = i / ln, n = i % ln, col = c0 + n;
        if (col < G) {
          p.logits_out[(static_cast<int64_t>(b) * R + r0 + rr) * G + col] =
              __float2bfloat16(L[rr * ln + n]);
        }
      }
    }
    // the tile's (max, sum of exp) a glimpse over its rows below R: each of
    // `parts` threads a run of rows, the runs merged in order
    if (sp < parts) {
      const int span = ceil_div(nr, parts), lo = sp * span, hi = min(nr, lo + span);
      float m = __int_as_float(0xff800000);
      for (int rr = lo; rr < hi; ++rr) m = fmaxf(m, L[rr * ln + sn]);
      float s = 0.f;
      for (int rr = lo; rr < hi; ++rr) s += expf(L[rr * ln + sn] - m);
      red[2 * tid] = m;
      red[2 * tid + 1] = s;
    }
    __syncthreads();
    if (tid < ln) {
      float m = __int_as_float(0xff800000);
      for (int q = 0; q < parts; ++q) m = fmaxf(m, red[2 * (q * ln + tid)]);
      float s = 0.f;
      for (int q = 0; q < parts; ++q) {
        const float sq = red[2 * (q * ln + tid) + 1];
        if (sq > 0.f) s += sq * expf(red[2 * (q * ln + tid)] - m);  // a run past nr: none
      }
      *reinterpret_cast<float2*>(
          p.stats + ((static_cast<int64_t>(b) * gtot + c0 + tid) * rtiles + rt) * 2) =
          make_float2(m, s);
    }
    __syncthreads();  // L and the partials free for the next tile
  }
}

// the weighted sum's shared memory: (m, l) of the group's kn glimpses, the
// ring's barriers (full, empty), then, on 1024 bytes, `stages` stages of
// v's two boxes, alpha^T [kn, 64] bf16 (128-byte rows, swizzled) and the
// stage's fp32 logits [64, kn]
template <int kN>
struct SumLayout {
  static constexpr int kAlpha = 2 * kVBox;
  static constexpr int kLogits = kAlpha + kN * 128;
  static constexpr int kStageBytes = kLogits + kStage * kN * 4;  // a multiple of 1024
  static constexpr int kLogitBytes = kStage * kN * 4;
  __host__ __device__ static constexpr size_t head(int stages) {
    return align16(8 * kN + 16 * stages);
  }
  __host__ __device__ static constexpr size_t total(int stages) {
    return head(stages) + 1024 + static_cast<size_t>(stages) * kStageBytes;
  }
};

__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// weighted sum: CTA (b, group q, chunk c, column block db) computes
// out[b, q kn.., 128 db..] over the regions of its chunk
template <int kN>
__global__ void __launch_bounds__(kThreads, kN <= 32 ? 2 : 1)
glimpse_tc_sum_kernel(const __grid_constant__ CUtensorMap v_map, const float* __restrict__ lg,
              const float* __restrict__ stats, bf16* __restrict__ out, float* __restrict__ part,
              int B, int R, int G, int D, int groups, int rtiles, int rpad, int chunks,
              int chunk_stages, int stages) {
  using S = SumLayout<kN>;
  constexpr int kAcc = kN / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* m_s = reinterpret_cast<float*>(smem_raw);  // [kn] each glimpse's max
  float* l_s = m_s + kN;                             // [kn] and its sum of exp
  uint64_t* full = reinterpret_cast<uint64_t*>(l_s + kN);
  uint64_t* empty = full + stages;
  unsigned char* head_end = smem_raw + S::head(stages);
  unsigned char* ring = head_end + ((1024 - (smem_addr(head_end) & 1023)) & 1023);
  const int n_db = ceil_div(D, kCols);
  const int db = static_cast<int>(blockIdx.x % n_db);
  int rest = static_cast<int>(blockIdx.x / n_db);
  const int c = rest % chunks;
  rest /= chunks;
  const int q = rest % groups, b = rest / groups;
  const int d0 = db * kCols;
  const int n_rt = ceil_div(R, kStage);
  const int s0 = c * chunk_stages, n_st = min(n_rt, s0 + chunk_stages) - s0;
  const int tid = threadIdx.x, lane = tid % 32;
  const bool second = d0 + 64 < D;  // the CTA's second box holds columns below D
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer
    if (lane == 0) {
      const float* lgq = lg + (static_cast<int64_t>(b) * groups + q) * rpad * kN;
      for (int i = 0; i < n_st; ++i) {
        const int st = i % stages, r0 = (s0 + i) * kStage;
        if (i >= stages) mbar_wait(empty + st, ((i / stages) - 1) & 1);
        unsigned char* base = ring + st * S::kStageBytes;
        mbar_expect_tx(full + st, (second ? 2 : 1) * kVBox + S::kLogitBytes);
        tma_3d(base, &v_map, full + st, d0, r0, b);
        if (second) tma_3d(base + kVBox, &v_map, full + st, d0 + 64, r0, b);
        bulk_load(base + S::kLogits, lgq + static_cast<int64_t>(r0) * kN, S::kLogitBytes,
                  full + st);
      }
    }
    return;
  }

  // each glimpse's tile statistics merged in tile order: m = max_t m_t,
  // l = sum_t l_t e^(m_t - m) (glimpses past G: alpha 0, by index below)
  const int gtot = groups * kN;
  if (tid < kN) {
    const int col = q * kN + tid;
    float m = 0.f, l = 1.f;
    if (col < G) {
      const float2* st =
          reinterpret_cast<const float2*>(stats) + (static_cast<int64_t>(b) * gtot + col) * rtiles;
      m = __int_as_float(0xff800000);
      for (int i = 0; i < rtiles; ++i) m = fmaxf(m, st[i].x);
      l = 0.f;
      for (int i = 0; i < rtiles; ++i) {
        const float2 v = st[i];
        l += v.y * expf(v.x - m);
      }
    }
    m_s[tid] = m;
    l_s[tid] = l;
  }
  consumers_sync();

  const int wg = tid / 128;
  float d[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) d[e] = 0.f;
  for (int i = 0; i < n_st; ++i) {
    const int st = i % stages, r0 = (s0 + i) * kStage;
    unsigned char* base = ring + st * S::kStageBytes;
    mbar_wait(full + st, (i / stages) & 1);
    // alpha^T [kn, 64]: a thread 8 regions of one glimpse, one 16-byte store
    // at row n, piece kc ^ (n % 8) (the 128-byte swizzle)
    const float* ls = reinterpret_cast<const float*>(base + S::kLogits);
    unsigned char* at = base + S::kAlpha;
    for (int item = tid; item < kN * 8; item += kConsumers) {
      const int n = item % kN, kc = item / kN, col = q * kN + n;
      const float m = m_s[n], l = l_s[n];
      uint32_t w4[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int k = kc * 8 + 2 * h;
        const float a0 = col < G && r0 + k < R ? expf(ls[k * kN + n] - m) / l : 0.f;
        const float a1 = col < G && r0 + k + 1 < R ? expf(ls[(k + 1) * kN + n] - m) / l : 0.f;
        const __nv_bfloat162 pr = __floats2bfloat162_rn(a0, a1);
        w4[h] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      *reinterpret_cast<uint4*>(at + n * 128 + ((kc ^ (n & 7)) << 4)) =
          make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
    fence_async_smem();
    consumers_sync();
    // out^T [64 columns, kn] += v^T alpha, four k16 steps over the stage's
    // 64 regions: A = warpgroup wg's box (16 rows of 128 bytes a step), B =
    // alpha^T's 16 regions (32 bytes along its swizzled rows)
    const unsigned char* vb = base + wg * kVBox;
    if (wg == 0 || second) {  // warpgroup-uniform: a box wholly past D is not loaded
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_vt<kN>(d, smem_desc(vb + kk * 16 * 128, kVBox, 1024), smem_desc(at + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d);
    }
    release(empty + st, lane);
  }

  // d[4 x + e] is out^T[column 64 wg + 16 wq + g + 8 (e / 2), glimpse
  // 8 x + 2 t + e % 2]
  const int wq = (tid / 32) % 4, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int x = 0; x < kN / 8; ++x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = q * kN + 8 * x + 2 * t4 + e % 2;
      const int dd = d0 + 64 * wg + 16 * wq + g + 8 * (e / 2);
      if (col < G && dd < D) {
        const int64_t at = (static_cast<int64_t>(b) * G + col) * D + dd;
        if (chunks == 1) {
          out[at] = __float2bfloat16(d[4 * x + e]);
        } else {
          part[static_cast<int64_t>(c) * B * G * D + at] = d[4 * x + e];
        }
      }
    }
  }
}

// the chunks' fp32 partials added in chunk order, rounded once
__global__ void __launch_bounds__(256) glimpse_tc_merge_kernel(const float* __restrict__ part,
                                                       bf16* __restrict__ out, int64_t n,
                                                       int chunks) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += part[c * n + i];
    out[i] = __float2bfloat16(s);
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled lives in libcuda; reach it through the runtime's
// entry-point query so that the library links against nothing but cudart.
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

// v [B, R, D] bf16 as a 3-D map in boxes of 64 columns (128 bytes) x 64
// regions x 1, 128-byte swizzle, zero past each batch row's R and past D
cudaError_t encode_v(CUtensorMap* map, const void* v, int B, int R, int D) {
  EncodeFn encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(R),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(D) * 2 * R};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(kStage), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(v), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// a kernel's opt-in to `bytes` of dynamic shared memory, set once a device
// (and again only for more): cudaFuncSetAttribute costs microseconds a call
constexpr int kDevices = 64;
struct OptIn {
  std::atomic<size_t> bytes[kDevices];
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, OptIn& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done.bytes[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kDevices) done.bytes[dev].store(bytes);
  return err;
}

// what a launch runs: its CTAs, the threads of a CTA, its dynamic shared
// memory (`which` 0 the logits kernel, 1 the weighted sum); the one
// reckoning the launchers and vqa_glimpse_tc_geometry share
struct Geometry {
  long long ctas, threads, smem;
};

template <int kN>
Geometry sum_geometry(const TcParams& p, int D, int stages, int chunks) {
  return {static_cast<long long>(p.B) * p.groups * chunks * ceil_div(D, kCols), kThreads,
          static_cast<long long>(SumLayout<kN>::total(stages))};
}

cudaError_t geometry_of(const TcParams& p, int D, int stages, int chunks, int slots, int which,
                        Geometry* g) {
  if (which == 0) {
    *g = {static_cast<long long>(p.groups * p.kn / p.ln) * slots, kLogitThreads,
          static_cast<long long>(logits_layout(p.rows, p.ln, p.M, p.M == 0).total)};
  } else if (which == 1) {
    switch (p.kn) {
      case 8: *g = sum_geometry<8>(p, D, stages, chunks); break;
      case 16: *g = sum_geometry<16>(p, D, stages, chunks); break;
      case 24: *g = sum_geometry<24>(p, D, stages, chunks); break;
      case 32: *g = sum_geometry<32>(p, D, stages, chunks); break;
      case 64: *g = sum_geometry<64>(p, D, stages, chunks); break;
      case 128: *g = sum_geometry<128>(p, D, stages, chunks); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return g->ctas < (1LL << 31) ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_logits(const TcParams& p, int slots, cudaStream_t s) {
  static OptIn done[3];  // one a kernel below
  const bool given = p.logits_in != nullptr;
  Geometry g;
  cudaError_t err = geometry_of(p, 0, 0, 1, slots, 0, &g);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(p.B) * ceil_div(p.R, p.rows);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const bool pair4 = p.M % 2 == 0 && reinterpret_cast<uintptr_t>(p.joint) % 4 == 0;
  const int k = given ? 0 : pair4 ? 1 : 2;
  auto kernel = k == 0   ? glimpse_tc_logits_kernel<true, true>
                : k == 1 ? glimpse_tc_logits_kernel<false, true>
                         : glimpse_tc_logits_kernel<false, false>;
  err = set_smem(kernel, static_cast<size_t>(g.smem), done[k]);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(g.ctas), kLogitThreads, static_cast<size_t>(g.smem), s>>>(
      p, slots);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch_sum(const TcParams& p, const bf16* v, bf16* out, float* part, int D,
                       int stages, int chunks, cudaStream_t s) {
  static OptIn done;
  const int n_rt = ceil_div(p.R, kStage), chunk_stages = ceil_div(n_rt, chunks);
  if (ceil_div(n_rt, chunk_stages) != chunks) return cudaErrorInvalidValue;
  Geometry g;
  cudaError_t err = geometry_of(p, D, stages, chunks, 1, 1, &g);
  if (err != cudaSuccess) return err;
  CUtensorMap v_map;
  err = encode_v(&v_map, v, p.B, p.R, D);
  if (err != cudaSuccess) return err;
  err = set_smem(glimpse_tc_sum_kernel<kN>, static_cast<size_t>(g.smem), done);
  if (err != cudaSuccess) return err;
  glimpse_tc_sum_kernel<kN><<<static_cast<unsigned>(g.ctas), kThreads,
                              static_cast<size_t>(g.smem), s>>>(
      v_map, p.lg, p.stats, out, part, p.B, p.R, p.G, D, p.groups, ceil_div(p.R, p.rows),
      p.rpad, chunks, chunk_stages, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const int64_t n = static_cast<int64_t>(p.B) * p.G * D;
  const int64_t blocks = (n + 255) / 256;
  glimpse_tc_merge_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      part, out, n, chunks);
  return cudaGetLastError();
}

// the parameters of a call, checked as vqa_glimpse_tc checks them (but for
// the pointers); false where they are out of range
bool make_params(const void* joint, const void* w, const void* bias, const void* logits_in,
                 void* logits_out, void* lg, void* stats, int B, int R, int M, int G, int D,
                 int kn, int rows, int ln, int stages, int chunks, int slots, TcParams* p) {
  if (B < 1 || R < 1 || G < 1 || D < 1 || M < 0 || D % 8 != 0 ||
      (rows != 16 && rows != 32 && rows != 64) || ln < 8 || ln > kMaxLn || ln % 8 != 0 ||
      kn % ln != 0 || stages < 2 || chunks < 1 || slots < 1 ||
      (kn != 8 && kn != 16 && kn != 24 && kn != 32 && kn != 64 && kn != 128))
    return false;
  *p = {static_cast<const bf16*>(joint), static_cast<const bf16*>(w),
        static_cast<const bf16*>(bias), static_cast<const bf16*>(logits_in),
        static_cast<bf16*>(logits_out), static_cast<float*>(lg), static_cast<float*>(stats),
        B, R, M, G, kn, ceil_div(G, kn), rows, ln, ceil_div(R, kStage) * kStage};
  return true;
}

}  // namespace

// The glimpse kernels' "tc" design (bf16; ops/attention.py::glimpse_plan,
// copy "tc") on `stream`: glimpse_head where `logits_in` is null (joint, w,
// bias given; logits_out written), else glimpse_attend. `launches` is a
// mask of the launches to make, in this order: 1 the logits kernel, `slots`
// CTAs a tile of `ln` glimpses (a multiple of 8 dividing kn) each walking
// tiles of `rows` regions, writing the fp32 logits into lg [B, groups, rpad,
// kn] (rpad = R rounded up to 64, groups = ceil(G / kn)) and their tile
// statistics into stats [B, groups kn, ceil(R / rows), 2]; 2 the weighted
// sum from them into out (with chunks > 1 through part [chunks, B, G, D]
// and the merge kernel), a ring of `stages` stages. lg, stats and part are
// fp32 scratch the caller allocates. Needs D % 8 == 0 and v and lg on 16
// bytes. Returns the first failing launch's cudaError_t, or 0.
extern "C" int vqa_glimpse_tc(const void* joint, const void* w, const void* bias,
                              const void* logits_in, const void* v, void* out, void* logits_out,
                              void* lg, void* stats, void* part, int B, int R, int M, int G, int D,
                              int kn, int rows, int ln, int stages, int chunks, int slots,
                              int launches, void* stream) {
  if (B <= 0) return 0;
  const bool given = logits_in != nullptr;
  TcParams p;
  if (!make_params(joint, w, bias, logits_in, logits_out, lg, stats, B, R, M, G, D, kn, rows, ln,
                   stages, chunks, slots, &p) ||
      (given ? M != 0 : M < 1) || lg == nullptr || stats == nullptr ||
      (chunks > 1 && part == nullptr) || launches < 1 || launches > 3 ||
      ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(lg)) % 16) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!given && (joint == nullptr || w == nullptr || bias == nullptr || logits_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (launches & 1) {
    const cudaError_t err = launch_logits(p, slots, s);
    if (err != cudaSuccess || !(launches & 2)) return static_cast<int>(err);
  }
  auto vv = static_cast<const bf16*>(v);
  auto o = static_cast<bf16*>(out);
  auto pt = static_cast<float*>(part);
  switch (kn) {
    case 8: return static_cast<int>(launch_sum<8>(p, vv, o, pt, D, stages, chunks, s));
    case 16: return static_cast<int>(launch_sum<16>(p, vv, o, pt, D, stages, chunks, s));
    case 24: return static_cast<int>(launch_sum<24>(p, vv, o, pt, D, stages, chunks, s));
    case 32: return static_cast<int>(launch_sum<32>(p, vv, o, pt, D, stages, chunks, s));
    case 64: return static_cast<int>(launch_sum<64>(p, vv, o, pt, D, stages, chunks, s));
    case 128: return static_cast<int>(launch_sum<128>(p, vv, o, pt, D, stages, chunks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What vqa_glimpse_tc launches for these arguments (M = 0: glimpse_attend):
// `which` 0 the logits kernel, 1 the weighted sum; geometry[0] its CTAs,
// [1] the threads of a CTA, [2] its dynamic shared memory. Returns a
// cudaError_t.
extern "C" int vqa_glimpse_tc_geometry(int B, int R, int M, int G, int D, int kn, int rows, int ln,
                                       int stages, int chunks, int slots, int which,
                                       long long* geometry_out) {
  TcParams p;
  if (!make_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, R, M, G, D,
                   kn, rows, ln, stages, chunks, slots, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  const cudaError_t err = geometry_of(p, D, stages, chunks, slots, which, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  geometry_out[0] = g.ctas;
  geometry_out[1] = g.threads;
  geometry_out[2] = g.smem;
  return 0;
}
