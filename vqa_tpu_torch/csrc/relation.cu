// relation_attend: the CoR relation core.
//
//   pg [B, N, D], r [B, N, D] (bf16)
//   s[b, i, j]     = sum_d pg[b, i, d] * r[b, j, d] / sqrt(D)
//   alpha[b, i, :] = softmax over j of s[b, i, :]
//   out[b, i, d]   = sum_j alpha[b, i, j] * r[b, j, d]       -> out [B, N, D] (bf16)
//
// Replaces vqa_tpu/ops/relation.py::_relation_attend_pallas (_pallas_fwd,
// _kernel). It follows the Pallas kernel's numerics: scores and softmax in
// fp32, alpha NOT rounded to bf16 before the second product, only the
// output rounded. Both products run on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulation): the scores multiply bf16
// values exactly; alpha enters the weighted sum as two bf16 halves,
// hi = bf16(alpha) and lo = bf16(alpha - hi), two products summed in fp32,
// which keeps it to ~2^-16 relative (a TF32 product, at the same cost,
// would keep 2^-11). The halves are packed in one word (hi | lo << 16), so
// one 8-byte load a column pair gives both A fragments.
//
// What bounds it on the H100: at the CoR shapes (B=1024, N=36, D=1024) it
// reads 151 MB and writes 75 MB: 0.068 ms at 3.35 TB/s; the products
// (3 x 1.36 G multiply-adds with the split) take ~0.008 ms at the bf16
// peak. At N=196 (the extract CLI's grid) 1.23 GB: 0.368 ms, the products
// ~0.25 ms. The parent (74dfedf: one block an element, r copied through
// registers, pg's fragments read from device memory, the weighted sum on the
// fp32 CUDA cores; at N > 64 both products on them) ran at 32% and 4.9% of
// those bounds (NVIDIA H100 80GB HBM3, 700 W). Its cuts showed the two
// products in series, not the bytes, were its time.
//
// Three designs, picked by ops/relation.py::relation_plan:
//
// "element" (N <= 64): a cluster of `split` CTAs an element (2 where D
// allows), CTA c owning columns [c D / split, (c + 1) D / split) of pg, r
// and out, 16 warps. Its rows of pg and r arrive by 1-D bulk copies (one a
// row, on one mbarrier) into shared memory, rows padded by 16 bytes so that
// the eight rows an ldmatrix reads at one column hit eight bank groups. It
// computes its partial scores (a warp a 16 x 16 tile), sends each peer the
// rows of them that the peer owns and receives its own rows' partials
// (bulk copies between the CTAs' shared memory, landing on the receiver's
// mbarrier), sums them in rank order (bit-equal across CTAs and runs), takes
// the softmax of its rows, exchanges alpha rows the same way, then computes
// its columns of the output, staged in pg's rows and bulk-stored. A CTA
// pair at N=36 holds ~91 KB a CTA, two an SM.
//
// "tiled" (N > 64): one CTA an element and 64 rows of i: a producer warp
// issues TMA boxes (128-byte swizzle) of 64 columns into a ring of up to 4
// stages: pg's 64 x 64 box and r's N rows for the scores, then r's rows
// again for the weighted sum. 16 consumer warps keep the scores in
// registers (a warp a 16-row tile and up to 4 pairs of 8-column tiles: N <=
// 256 in one pass over D, more in passes), store s [64, N] (fp32) in shared
// memory, take the softmax a warp a row and write alpha in place as packed
// words; then four warps a chunk (four chunks in flight) run the weighted
// sum and TMA-store the chunk's output through the stage's idle pg box (a
// 3-D map clips at the element's last row). r[b] leaves L2 twice a CTA.
//
// "wide": the parent's N > 64 kernel, kept for N past the tiled design's
// shared memory (below).
//
// "split": the wide design over chunks of r's rows, for N past the wide
// design's shared memory (bf16 N > ~3100, float32 N > ~2600 at D=1024, e.g.
// the 56 x 56 grid of a 1792-pixel extract). A block owns (element, 16
// rows of i, one chunk of r's rows): its shared memory holds pg's 16 rows
// and s^T [chunk, 16], whatever N. It writes the chunk's unnormalised fp32
// partial output and each row's (max, sum of exp) to scratch, and
// lse_merge.cuh's kernel merges the chunks by their log-sum-exp. What
// bounds it: the products on the CUDA cores, as the wide design's (at
// N=3136, B=64, D=1024: 2.58 TFLOP, 39 ms at the 67 TFLOP/s FP32 peak),
// then the scratch, C x 4 bytes an output element written and read again.
//
// D % 8 != 0, or a pointer off 16 bytes, takes the same designs with plain
// copies and plain stores (the element design one CTA an element; the tiled
// producer warp swizzles by hand).
//
// float32 (the entry vqa_relation_attend_f32): the Pallas kernel computes in
// its input's dtype, so in float32 nothing is rounded: scores, softmax,
// alpha and the weighted sum in fp32, the output stored as it is. What bounds
// it on the H100: at N=196, B=1024, D=1024 its 161 GFLOP of products (2.4 ms
// at the 67 TFLOP/s FP32 peak of the CUDA cores); at N=36 its bytes (302 MB
// read, 151 MB written: 0.135 ms at 3.35 TB/s). Single-pass TF32 on the
// tensor cores keeps ~3 decimal digits, so float32 runs both products as
// 3xTF32: each operand x split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), and a.b taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32
// (the dropped a_lo.b_lo is ~2^-22 relative): three passes at the 495
// TFLOP/s TF32 peak, 0.976 ms at N=196. mma.sync's tf32 is slow on the H100
// (with both products on it, and the splits redone by every warp that read a
// fragment, the design ran no faster than SDPA at N=196), so both products
// run on wgmma, whose tf32 operands in shared memory must be K-major and
// whose A may come from registers. The design is "tiled" with the element type a template
// parameter, up to N = 256: a stage is still 128-byte swizzled rows (32
// float32 columns), s [64, N] stays fp32, alpha is not rounded.
//   - scores, transposed: s^T = r . pg^T as m64n64k8, warpgroup q taking r's
//     rows 64 q.. (A: ldmatrix from the stage, a 16-byte row of an 8 x 8 b16
//     matrix being four tf32 in mma's tf32 fragment order, split in
//     registers) against the tile's 64 rows of pg (B, K-major as it lies:
//     the consumer threads split the stage's pg box once, hi in place and lo
//     into one of two buffers at the same offset, so the swizzle carries
//     over); three a k8, one group a k8, A's registers double buffered.
//   - the softmax keeps each warp's rows in registers (hence N <= 256) and
//     writes alpha's tf32 halves over s as the weighted sum's B: K-major
//     blocks of 32 columns, 64 rows x 128 bytes, 128-byte swizzle.
//   - weighted sum, transposed: out^T = r^T . alpha^T as m64n64k8, M = two
//     32-column chunks (r's rows are MN-major, so A comes from registers:
//     4-byte loads of rows t, t + 4 of a column, 16-byte pieces chosen so
//     that a load's four rows hit 32 banks, split in registers), a
//     warpgroup a pair of chunks (it keeps the first one's stage until the
//     second one's has come); the output transposed into the stages' idle pg
//     boxes and TMA-stored.
// Past N = 256 (or a stage past the shared memory), the wide design above,
// FP32 FMA on the CUDA cores; past the wide design's shared memory, the
// split one. ops/relation.py::relation_plan with 4-byte
// elements chooses the design and its stages; this entry runs what it is
// given, and refuses a schedule the design cannot run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lse_merge.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // the wide and split designs' warps
constexpr int kThreads = 32 * kWarps;
constexpr int kEW = 16;             // element design: warps a CTA (512 beat 256 threads)
constexpr int kMaxN = 64;           // element design: s at most 4 x 16 rows, 8 x 8 columns
constexpr int kMaxKt = kMaxN / 16;  // its k-steps over j in the weighted sum
constexpr int kMaxSplit = 8;        // the portable cluster size
constexpr int kMinCols = 64;        // columns a split CTA keeps
constexpr int kDesignElement = 0, kDesignTiled = 1, kDesignWide = 2, kDesignSplit = 3;
constexpr int kTileRows = 64;  // tiled design: rows of i a CTA
template <typename T>
constexpr int kChunk = 128 / sizeof(T);  // columns a stage: one 128-byte swizzled row
constexpr int kBoxRows = 256;  // rows of a TMA box
constexpr int kMaxStages = 4;
constexpr int kTW = 16;            // the tiled design's consumer warps (one more produces)
constexpr int kTQ = kTW / 4;       // its warps on one 16-row tile of i
constexpr int kPairsPerPass = 16;  // tiled scores: pairs of 8-column tiles of s a pass over D
constexpr int kPairsPerWarp = kPairsPerPass / kTQ;
static_assert(kTW / kTQ == kTileRows / 16, "a quarter's warps cover a tile's rows");
constexpr int kRowRegs = 8;        // tiled softmax: a row's values a lane keeps, up to N = 256
constexpr int kMaxF32N = 32 * kRowRegs;  // float32's tiled design: its softmax rows in registers
constexpr int kBlock = kTileRows * 128;  // float32: one K block of alpha's halves (32 columns)

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int x, int m) { return ceil_div(x, m) * m; }
__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// ------------------------------------------------------------ the layouts

// element design, one CTA: its columns dc (dcp rounded up to 16, zero past
// dc), the row stride ld (bf16) of pg and r, np = N rounded up to 16, the
// row stride sa (bytes) of alpha's packed words, np4 = N rounded up to 4
// (the row stride of the scores, so a row is whole 16-byte pieces), the
// rows of s each CTA owns (rows_per = ceil(N / split): CTA c owns rows
// [c rows_per, (c + 1) rows_per)). Byte offsets: three barriers (the copy
// from device memory, the peers' partial scores, the peers' alpha rows), pg,
// r, this CTA's partial s [N, np4], the peers' partials of its rows
// [split - 1][rows_per][np4] (fp32), alpha [np, np]
struct Shape {
  int dc, dcp, ld, np, sa, np4, rows_per;
  size_t pg, r, part, slots, alpha, total;
};

__host__ __device__ inline Shape shape_of(int N, int D, int split) {
  Shape s;
  s.dc = ceil_div(D, split);
  s.dcp = round_up(s.dc, 16);
  s.ld = s.dcp + 8;
  s.np = round_up(N, 16);
  s.sa = 4 * s.np + 32;  // 32 or 96 mod 128: a quarter warp's 8-byte loads miss each other
  s.np4 = round_up(N, 4);
  s.rows_per = ceil_div(N, split);
  s.pg = 32;
  s.r = s.pg + align16(static_cast<size_t>(N) * s.ld * 2);
  s.part = s.r + align16(static_cast<size_t>(N) * s.ld * 2);
  s.slots = s.part + static_cast<size_t>(N) * s.np4 * 4;
  s.alpha = s.slots + static_cast<size_t>(split - 1) * s.rows_per * s.np4 * 4;
  s.total = s.alpha + static_cast<size_t>(s.np) * s.sa;
  return s;
}

// tiled design: r's boxes a stage (nbox of rb rows, rb % 8 == 0 so every box
// starts on 1 KB and row j of the stage's r is at j * 128 with swizzle j & 7),
// nj = N rounded up to 16, the row stride sr (bytes) of s / alpha (bf16:
// 4 nj + 32, for 8-byte loads of packed words; float32: 4 nj + 16, for
// ldmatrix); the bytes of pg's box and of a stage (128-byte rows in either
// type: 64 bf16 or 32 float32 columns). Shared memory: 1 KB of alignment
// slack, the ring, s [64, sr], the barriers (full, empty)
struct TiledShape {
  int nbox, rb, nj, sr, nblk;
  size_t pg_box, stage, lo, region;
};

__host__ __device__ inline TiledShape tiled_shape(int N, int elem) {
  TiledShape t;
  t.nbox = ceil_div(N, kBoxRows);
  t.rb = round_up(ceil_div(N, t.nbox), 8);
  t.nj = round_up(N, 16);
  t.sr = 4 * t.nj + (elem == 2 ? 32 : 16);
  t.pg_box = static_cast<size_t>(kTileRows) * 128;
  t.stage = t.pg_box + static_cast<size_t>(t.nbox) * t.rb * 128;
  // float32: two buffers of the lo half of a stage's pg (the scores' wgmma
  // B); after the scores, the same region holds alpha's tf32 halves as the
  // weighted sum's wgmma B: nblk K blocks of 32 columns each, hi then lo
  t.nblk = ceil_div(t.nj, 32);
  t.lo = elem == 2 ? 0 : 2 * t.pg_box;
  const size_t scores = t.lo + static_cast<size_t>(kTileRows) * t.sr;
  const size_t alpha = elem == 2 ? 0 : 2 * static_cast<size_t>(t.nblk) * kBlock;
  t.region = scores > alpha ? scores : alpha;
  return t;
}

// the ring, then the region (bf16: s; float32: the lo halves and s, then
// alpha's halves), the barriers
size_t tiled_smem(int N, int stages, int elem) {
  const TiledShape t = tiled_shape(N, elem);
  return 1024 + stages * t.stage + t.region + 16 * stages;
}

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

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// shared memory at `src` (a 128-byte-swizzled box) to `map` at (c0, c1, c2),
// in this thread's bulk group; the map clips what falls outside the tensor
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from this CTA's shared memory at `src` to
// `dst`'s offset in cluster CTA `rank`, completing on the barrier at `bar`'s
// offset there
__device__ __forceinline__ void bulk_to_peer(const void* dst, const void* src, unsigned bytes,
                                             const uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n.reg .b32 d, b;\n"
      "mapa.shared::cluster.u32 d, %0, %3;\n"
      "mapa.shared::cluster.u32 b, %2, %3;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [d], [%1], %4, [b];\n"
      "}\n" ::"r"(smem_addr(dst)),
      "r"(smem_addr(src)), "r"(smem_addr(bar)), "r"(rank), "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses on 16 bytes) from shared to
// global memory, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// generic-proxy writes to shared memory made visible to the bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the tiled design's kTQ consumer warps 4 q .. 4 q + 3 (named barrier 2 + q)
__device__ __forceinline__ void group_sync(int q) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + q) : "memory");
}

// the consumer warps of the tiled design, without the producer
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kTW) : "memory");
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 accumulate.
// Fragments: lane = 4 g + t holds A rows g, g + 8 at columns 2t, 2t+1 and
// 2t+8, 2t+9; B column g at rows 2t, 2t+1 and 2t+8, 2t+9; C rows g, g + 8 at
// columns 2t, 2t+1
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t lds_u32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// alpha as two bf16 halves in one word: hi = bf16(a) low, lo = bf16(a - hi) high
__device__ __forceinline__ uint32_t pack_alpha(float a) {
  const bf16 hi = __float2bfloat16(a);
  const bf16 lo = __float2bfloat16(a - __bfloat162float(hi));
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16);
}

// the A fragments of alpha's halves for rows row0.., columns k0.. from the
// packed words at `a` (row stride `stride` bytes): one 8-byte load a pair of
// columns gives both halves
__device__ __forceinline__ void alpha_frag(const unsigned char* a, int stride, int row0, int k0,
                                           int lane, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = row0 + g + (q % 2) * 8, col = k0 + 2 * t + (q / 2) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(a + row * stride + col * 4);
    hi[q] = __byte_perm(w.x, w.y, 0x5410);
    lo[q] = __byte_perm(w.x, w.y, 0x7632);
  }
}

// the element types' conversions from and to fp32; out[i, d], out[i, d + 1]
// from fp32 by plain stores (the paths whose rows are not on 16 bytes), the
// second where it exists
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y, bool second) {
  p[0] = from_float<T>(x);
  if (second) p[1] = from_float<T>(y);
}

// ------------------------------------------------------- element design

template <bool kVec>
__global__ void __launch_bounds__(32 * kEW, 2)
relation_element_kernel(const bf16* __restrict__ pg, const bf16* __restrict__ r,
                        bf16* __restrict__ out, int N, int D, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape sh = shape_of(N, D, split);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // copy, partials, alpha
  bf16* pg_s = reinterpret_cast<bf16*>(smem + sh.pg);
  bf16* r_s = reinterpret_cast<bf16*>(smem + sh.r);
  float* part = reinterpret_cast<float*>(smem + sh.part);
  float* slots = reinterpret_cast<float*>(smem + sh.slots);
  unsigned char* alpha = smem + sh.alpha;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = static_cast<int>(blockIdx.x % split);  // the cluster is (split, 1, 1)
  const int dc = sh.dc;
  const int64_t base = static_cast<int64_t>(blockIdx.x / split) * N * D + rank * dc;
  const bf16* pgb = pg + base;
  const bf16* rb = r + base;
  bf16* ob = out + base;
  auto rows_of = [&](int c) { return max(0, min(N, (c + 1) * sh.rows_per) - c * sh.rows_per); };
  const int row0 = rank * sh.rows_per, mine = rows_of(rank);  // the rows of s this CTA owns

  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(bar + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this CTA (and its barriers) has started: its peers may copy into it once they wait
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (kVec) {  // zero the columns [dc, dcp) of every row (D % 16 == 8)
    const int pad = sh.dcp - dc;
    for (int x = tid; x < 2 * N * pad; x += 32 * kEW) {
      const int row = x / pad;
      bf16* dst = row < N ? pg_s + row * sh.ld : r_s + (row - N) * sh.ld;
      dst[dc + x % pad] = __float2bfloat16(0.f);
    }
  } else {  // split == 1: every column by plain copies, zero past D
    for (int x = tid; x < 2 * N * sh.dcp; x += 32 * kEW) {
      const int row = x / sh.dcp, col = x % sh.dcp;
      const bool is_r = row >= N;
      const int i = is_r ? row - N : row;
      const bf16* src = (is_r ? rb : pgb) + static_cast<int64_t>(i) * D;
      (is_r ? r_s : pg_s)[i * sh.ld + col] = col < D ? src[col] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();
  if (split > 1 && tid == 0) {  // what the peers will send: their partials of my rows, their alpha
    int alpha_rows = 0;
    for (int q = 0; q < split; ++q) alpha_rows += q == rank ? 0 : rows_of(q);
    mbar_expect_tx(bar + 1, static_cast<unsigned>((split - 1) * mine * sh.np4 * 4));
    mbar_expect_tx(bar + 2, static_cast<unsigned>(alpha_rows * sh.sa));
  }
  if (kVec) {
    if (warp == 0) {  // one bulk copy a row of pg and of r
      const unsigned row_bytes = 2u * dc;
      const unsigned copy_bytes = 2u * N * row_bytes;
      if (lane == 0) mbar_expect_tx(bar, copy_bytes);
      __syncwarp();
      for (int row = lane; row < 2 * N; row += 32) {
        const bool is_r = row >= N;
        const int i = is_r ? row - N : row;
        bulk_load((is_r ? r_s : pg_s) + i * sh.ld, (is_r ? rb : pgb) + static_cast<int64_t>(i) * D,
                  row_bytes, bar);
      }
    }
    mbar_wait(bar, 0);
  }

  // partial s = pg . r^T over this CTA's columns, a warp a 16 x 16 tile.
  // ldmatrix rows (clamped to N - 1; those rows of s are never read): A rows
  // i0 + lane % 16 at column (lane / 16) * 8; B rows j0 + lane % 8 +
  // (lane / 16) * 8 at column ((lane / 8) % 2) * 8 (b[0..1] the first
  // 8-column tile, b[2..3] the second)
  const int mts = sh.np / 16;
  const int units = mts * mts;
  for (int u = warp; u < units; u += kEW) {
    const int i0 = (u % mts) * 16, j0 = (u / mts) * 16;
    const unsigned a_addr =
        smem_addr(pg_s + min(i0 + lane % 16, N - 1) * sh.ld + (lane / 16) * 8);
    const unsigned b_addr =
        smem_addr(r_s + min(j0 + lane % 8 + (lane / 16) * 8, N - 1) * sh.ld + ((lane / 8) % 2) * 8);
    float acc[2][4] = {};
#pragma unroll 4
    for (int k = 0; k < sh.dcp; k += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, a_addr + 2 * k);
      ldsm_x4(b, b_addr + 2 * k);
      mma_16816(acc[0], a, b[0], b[1]);
      mma_16816(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + (e / 2) * 8, j = j0 + q * 8 + 2 * t + e % 2;
        if (i < N && j < N) part[i * sh.np4 + j] = acc[q][e];
      }
    }
  }
  __syncthreads();
  if (split > 1) {
    // each peer's rows of this partial to it, one bulk copy a peer
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer started
    if (tid == 0) {
      fence_async_smem();
      for (int q = 0; q < split; ++q) {
        const int n = rows_of(q), at = q < rank ? rank - 1 : rank;  // my slot at q
        if (q != rank && n > 0) {
          bulk_to_peer(slots + static_cast<size_t>(at) * sh.rows_per * sh.np4,
                       part + q * sh.rows_per * sh.np4, static_cast<unsigned>(n * sh.np4 * 4),
                       bar + 1, q);
        }
      }
    }
    mbar_wait(bar + 1, 0);
  }

  // alpha = softmax_j(s / sqrt(D)) in fp32 for this CTA's rows, a warp a
  // row (N <= 64), the cluster's partials summed in rank order; packed
  // words, zero past N; then each peer gets these rows, one bulk copy a peer
  const float scale = rsqrtf(static_cast<float>(D));
  const float neg_inf = __int_as_float(0xff800000);
  for (int li = warp; li < mine; li += kEW) {  // softmax
    const int i = row0 + li;
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      v[h] = neg_inf;
      if (j < N) {
        float x = 0.f;
        for (int q = 0; q < split; ++q) {
          const int at = q < rank ? q : q - 1;
          x += q == rank ? part[i * sh.np4 + j]
                         : slots[(static_cast<size_t>(at) * sh.rows_per + li) * sh.np4 + j];
        }
        v[h] = x * scale;
      }
    }
    const float mx = warp_max(fmaxf(v[0], v[1]));
    const float e0 = lane < N ? expf(v[0] - mx) : 0.f;
    const float e1 = lane + 32 < N ? expf(v[1] - mx) : 0.f;
    const float inv = 1.f / warp_sum(e0 + e1);
    uint32_t* row = reinterpret_cast<uint32_t*>(alpha + i * sh.sa);
    if (lane < sh.np) row[lane] = lane < N ? pack_alpha(e0 * inv) : 0u;
    if (lane + 32 < sh.np) row[lane + 32] = lane + 32 < N ? pack_alpha(e1 * inv) : 0u;
  }
  __syncthreads();
  if (split > 1) {
    if (tid == 0 && mine > 0) {
      fence_async_smem();
      for (int q = 0; q < split; ++q) {
        if (q != rank) {
          bulk_to_peer(alpha + row0 * sh.sa, alpha + row0 * sh.sa,
                       static_cast<unsigned>(mine * sh.sa), bar + 2, q);
        }
      }
    }
    mbar_wait(bar + 2, 0);
    cluster_arrive();  // everything sent to this CTA has landed
  }

  // out[i, columns] = alpha . r[:, columns], a warp 16 rows x 32 columns:
  // per 16 rows of j, both halves of alpha against one ldmatrix.trans of r
  // a 16-column pair (rows j + lane % 8 + ((lane / 8) % 2) * 8, clamped to
  // N - 1 where alpha is 0, at column d0 + (lane / 16) * 8). The output
  // goes through pg's rows (free since the scores) to one bulk store a row
  const int kts = mts;
  const int dquads = ceil_div(sh.dcp, 32);
  for (int u = warp; u < mts * dquads; u += kEW) {
    const int i0 = (u % mts) * 16, d0 = (u / mts) * 32;
    const bool two = d0 + 16 < sh.dcp;  // uniform across the warp
    float acc[2][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < kMaxKt; ++kt) {  // weighted sum
      if (kt < kts) {
        uint32_t hi[4], lo[4];
        alpha_frag(alpha, sh.sa, i0, kt * 16, lane, hi, lo);
        const int j = min(kt * 16 + lane % 8 + ((lane / 8) % 2) * 8, N - 1);
        const bf16* rj = r_s + j * sh.ld + d0 + (lane / 16) * 8;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (x == 0 || two) {
            uint32_t b[4];
            ldsm_x4_trans(b, smem_addr(rj + 16 * x));
            mma_16816(acc[x][0], hi, b[0], b[1]);
            mma_16816(acc[x][0], lo, b[0], b[1]);
            mma_16816(acc[x][1], hi, b[2], b[3]);
            mma_16816(acc[x][1], lo, b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + g + 8 * h, d = d0 + 16 * x + q * 8 + 2 * t;
          const bool store_ok = i < N && d < dc;
          if (store_ok) {
            if (kVec) {
              *reinterpret_cast<__nv_bfloat162*>(pg_s + i * sh.ld + d) =
                  __floats2bfloat162_rn(acc[x][q][2 * h], acc[x][q][2 * h + 1]);
            } else {
              store_pair(ob + static_cast<int64_t>(i) * D + d, acc[x][q][2 * h],
                         acc[x][q][2 * h + 1], d + 1 < dc);
            }
          }
        }
      }
    }
  }
  if (kVec) {
    fence_async_smem();
    __syncthreads();
    if (warp == 0) {
      for (int i = lane; i < N; i += 32) {
        bulk_store(ob + static_cast<int64_t>(i) * D, pg_s + i * sh.ld, 2u * dc);
      }
      bulk_commit_and_wait_read();  // pg_s read out before the CTA leaves
    }
  }
  if (split > 1) cluster_wait();  // no CTA leaves while a peer may still copy from it
}

// --------------------------------------------------------- tiled design

// bf16: one 64-column chunk of the scores: this warp's 16 rows (mt)
// against its pairs of 8-column tiles (p0, p0 + 4, ...; up to 4 of them),
// from the stage `st` (pg's 64 x 64 box, then r's rows at j * 128, both
// 128-byte swizzled)
__device__ __forceinline__ void score_chunk(const unsigned char* st, const TiledShape& sh, int mt,
                                            int p0, int pairs, int N, int lane,
                                            float (&acc)[kPairsPerWarp][2][4]) {
  const int arow = mt * 16 + lane % 16;
  const unsigned a_base = smem_addr(st) + arow * 128;
  const unsigned r_base = smem_addr(st + sh.pg_box);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_base + (((2 * ks + lane / 16) ^ (arow & 7)) << 4));
#pragma unroll
    for (int x = 0; x < kPairsPerWarp; ++x) {
      const int p = p0 + kTQ * x;
      if (p < pairs) {  // uniform across the warp
        const int j = min(p * 16 + lane % 8 + (lane / 16) * 8, N - 1);
        uint32_t b[4];
        ldsm_x4(b, r_base + j * 128 + (((2 * ks + (lane / 8) % 2) ^ (j & 7)) << 4));
        mma_16816(acc[x][0], a, b[0], b[1]);
        mma_16816(acc[x][1], a, b[2], b[3]);
      }
    }
  }
}

// float32: a stage's pg box split into tf32 halves by the consumer threads
// (a 16-byte piece each), hi in place and lo at the same offset of `lo` (so
// the 128-byte swizzle, a function of the address within 1 KB, carries over)
__device__ __forceinline__ void split_pg(unsigned char* st, unsigned char* lo, int tid) {
  static_assert(kTileRows * 128 / 16 == 32 * kTW, "a piece a consumer thread");
  float4* p = reinterpret_cast<float4*>(st) + tid;
  const float4 v = *p;
  float4 h, l;
  split_f32(v.x, h.x, l.x);
  split_f32(v.y, h.y, l.y);
  split_f32(v.z, h.z, l.z);
  split_f32(v.w, h.w, l.w);
  *p = h;
  reinterpret_cast<float4*>(lo)[tid] = l;
}

// Shared-memory descriptor, K-major with the 128-byte swizzle (LBO unused,
// SBO = 1024: eight 128-byte rows), as csrc/lstm.cu's probes settled it
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a >> 4) & 0x3FFF) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the producer warp's plain copy of one stage (no TMA: D % 8 != 0 or a
// pointer off 16 bytes), zero past N and D, in TMA's 128-byte swizzle
template <typename T>
__device__ __forceinline__ void copy_chunk_plain(unsigned char* st, const TiledShape& sh,
                                                 const T* pgb, const T* rb, int i0, int col0,
                                                 bool scores, int N, int D, int lane) {
  constexpr int kC = kChunk<T>, kPer = 16 / sizeof(T);  // columns a stage, a 16-byte piece
  auto put = [&](unsigned char* box, int row, int cc, T v) {
    *reinterpret_cast<T*>(box + row * 128 + (((cc / kPer) ^ (row & 7)) << 4) +
                          (cc % kPer) * sizeof(T)) = v;
  };
  const T zero = from_float<T>(0.f);
  if (scores) {
    for (int x = lane; x < kTileRows * kC; x += 32) {
      const int row = x / kC, cc = x % kC, i = i0 + row, col = col0 + cc;
      put(st, row, cc, i < N && col < D ? pgb[static_cast<int64_t>(i) * D + col] : zero);
    }
  }
  for (int x = lane; x < sh.nbox * sh.rb * kC; x += 32) {
    const int j = x / kC, cc = x % kC, col = col0 + cc;
    put(st + sh.pg_box, j, cc, j < N && col < D ? rb[static_cast<int64_t>(j) * D + col] : zero);
  }
}

// d += A (64x8, registers) * B (8x64, K-major), tf32 in, fp32 accumulate;
// A's fragment as mma.sync m16n8k8's for each warp's 16 rows (lane 4 g + t:
// rows g, g + 8 at column t, then at column t + 4)
__device__ __forceinline__ void wgmma_64x64_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// registers that an in-flight wgmma reads or writes, kept in place until here
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// float32's weighted sum of two 32-column chunks, transposed: out^T[d, i] =
// sum_j r[j, d] alpha[i, j] as wgmma m64n64k8 (M = the two chunks' columns,
// N = the tile's 64 rows), three a k8 (lo.hi, hi.lo, hi.hi). B is alpha's
// halves (K-major blocks written by the softmax); A is r's, from registers:
// each warp reads rows t, t + 4 of the k8 of its chunk (warps 0, 1 the first,
// 2, 3 the second; none: zeros) by 4-byte loads and splits them, row m = 16
// w + g + 8 h of the warp's 16 being its chunk's column 4 (2 (w % 2) + h + 4
// (g / 4)) + g % 4, so that a load's four rows hit 32 banks. Two k8 a
// group, A's registers double buffered: a group's loads and split overlap
// the last group's wgmma.
__device__ __forceinline__ void weighted_chunk_f32(const unsigned char* alpha_hi,
                                                   const unsigned char* alpha_lo, int nk8,
                                                   unsigned r_base, bool has, int N, int half,
                                                   int lane, float (&acc)[32]) {
  const int g = lane / 4, t = lane % 4;
  const int p0 = 2 * half + 4 * (g / 4), p1 = p0 + 1;  // the 16-byte pieces of rows g, g + 8
  const unsigned col = (g % 4) * 4;
  uint32_t ah[2][2][4], al[2][2][4];
  // k8 steps kt and kt + 1 (nk8 is even) in one group
  auto step = [&](int kt, uint32_t (&h)[2][4], uint32_t (&l)[2][4]) {
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the group before last
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      fence_regs(h[q]);
      fence_regs(l[q]);
      uint32_t a[4] = {0u, 0u, 0u, 0u};
      if (has) {
        // rows past N (alpha 0 there) clamped to N - 1: the box may end before nj
        const int j0 = min((kt + q) * 8 + t, N - 1), j1 = min((kt + q) * 8 + 4 + t, N - 1);
        a[0] = lds_u32(r_base + j0 * 128 + ((p0 ^ (j0 & 7)) << 4) + col);
        a[1] = lds_u32(r_base + j0 * 128 + ((p1 ^ (j0 & 7)) << 4) + col);
        a[2] = lds_u32(r_base + j1 * 128 + ((p0 ^ (j1 & 7)) << 4) + col);
        a[3] = lds_u32(r_base + j1 * 128 + ((p1 ^ (j1 & 7)) << 4) + col);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], h[q][e], l[q][e]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int blk = ((kt + q) / 4) * kBlock + ((kt + q) % 4) * 32;
      wgmma_64x64_tf32_rs(acc, l[q], smem_desc(alpha_hi + blk));
      wgmma_64x64_tf32_rs(acc, h[q], smem_desc(alpha_lo + blk));
      wgmma_64x64_tf32_rs(acc, h[q], smem_desc(alpha_hi + blk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  for (int kt = 0; kt < nk8; kt += 4) {
    step(kt, ah[0], al[0]);
    if (kt + 2 < nk8) step(kt + 2, ah[1], al[1]);
  }
  wgmma_wait_all();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    fence_regs(ah[0][q]);
    fence_regs(al[0][q]);
    fence_regs(ah[1][q]);
    fence_regs(al[1][q]);
  }
  fence_acc(acc);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kTW + 32, 1)
relation_tiled_kernel(const __grid_constant__ CUtensorMap pg_map,
                      const __grid_constant__ CUtensorMap r_map,
                      const __grid_constant__ CUtensorMap out_map, const T* __restrict__ pg,
                      const T* __restrict__ r, T* __restrict__ out, int N, int D, int stages) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kC = kChunk<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledShape sh = tiled_shape(N, sizeof(T));
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* lo_base = ring + stages * sh.stage;  // float32: the lo halves, then alpha's
  unsigned char* s_base = lo_base + sh.lo;
  unsigned char* alpha_lo = lo_base + static_cast<size_t>(sh.nblk) * kBlock;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + sh.region);
  uint64_t* empty = full + stages;
  const int n_tiles = ceil_div(N, kTileRows);
  const int64_t b = blockIdx.x / n_tiles;
  const int i0 = (blockIdx.x % n_tiles) * kTileRows;
  const int rows = min(kTileRows, N - i0);
  const int kc = ceil_div(D, kC);              // chunks of D
  const int pairs = sh.nj / 16;                // pairs of 8-column tiles of s
  const int passes = ceil_div(pairs, kPairsPerPass);
  const int n_chunks = (passes + 1) * kc;      // the scores' passes, then the weighted sum
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kTW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTW) {  // the producer
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % stages;
      if (c >= stages) mbar_wait(empty + s, ((c / stages) - 1) & 1);
      unsigned char* st = ring + s * sh.stage;
      const bool scores = c < passes * kc;
      const int col0 = (scores ? c % kc : c - passes * kc) * kC;
      if (kVec) {
        if (lane == 0) {
          const unsigned stage_tx =
              static_cast<unsigned>((scores ? sh.pg_box : 0) + sh.stage - sh.pg_box);
          mbar_expect_tx(full + s, stage_tx);
          if (scores) tma_2d(st, &pg_map, full + s, col0, static_cast<int>(b * N + i0));
          for (int q = 0; q < sh.nbox; ++q) {
            tma_2d(st + sh.pg_box + static_cast<size_t>(q) * sh.rb * 128, &r_map, full + s, col0,
                   static_cast<int>(b * N + q * sh.rb));
          }
        }
      } else {
        copy_chunk_plain(st, sh, pg + b * N * D, r + b * N * D, i0, col0, scores, N, D, lane);
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + s);
      }
    }
    return;
  }

  // the scores. bf16: warp w owns rows (w % 4) * 16.. and, in each pass, the
  // pairs of 8-column tiles of s p = pass * 16 + w / 4 + 4 x, kept in
  // registers over the pass's chunks, then stored to s (fp32). float32: each chunk is split into tf32 halves in shared
  // memory by all consumer warps (split_stage), then warpgroup q = w / 4
  // runs columns pass * 256 + 64 q.. of s over the tile's 64 rows as
  // wgmma m64n64k8, three a k8 (lo.hi, hi.lo, hi.hi); the lo buffers are
  // rewritten only once the last chunk's wgmma have retired
  const int g = lane / 4, t = lane % 4;
  const int mt = warp % 4, quarter = warp / 4;
  int c = 0;
  for (int pass = 0; pass < passes; ++pass) {
    if constexpr (kF32) {
      float d[32] = {};
      const int j0 = pass * kPairsPerPass * 16 + quarter * 64;
      const bool wg_busy = j0 < sh.nj;  // uniform across the warpgroup
      const int jrow = min(j0 + mt * 16 + lane % 16, N - 1);  // this lane's ldmatrix row of r
      uint32_t ah[2][4], al[2][4];
      int prev = -1;
      for (int k = 0; k < kc; ++k, ++c) {
        const int s = c % stages;
        unsigned char* st = ring + s * sh.stage;
        unsigned char* lo = lo_base + (c & 1) * sh.pg_box;
        mbar_wait(full + s, (c / stages) & 1);
        consumers_sync();  // the groups that read lo (chunk c - 2) have retired in every warpgroup
        split_pg(st, lo, tid);
        fence_async_smem();
        consumers_sync();
        if (wg_busy) {
          const unsigned r_row = smem_addr(st + sh.pg_box) + jrow * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // a k8 a group, A's registers double buffered
            uint32_t (&h)[4] = ah[kk % 2];
            uint32_t (&l)[4] = al[kk % 2];
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            fence_regs(h);
            fence_regs(l);
            uint32_t x[4];
            ldsm_x4(x, r_row + (((2 * kk + lane / 16) ^ (jrow & 7)) << 4));
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(x[e], h[e], l[e]);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            wgmma_64x64_tf32_rs(d, l, smem_desc(st + kk * 32));
            wgmma_64x64_tf32_rs(d, h, smem_desc(lo + kk * 32));
            wgmma_64x64_tf32_rs(d, h, smem_desc(st + kk * 32));
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          }
        }
        // at most the last group is in flight: the last chunk's stage is free
        if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
      }
      wgmma_wait_all();
      fence_regs(ah[0]);
      fence_regs(al[0]);
      fence_regs(ah[1]);
      fence_regs(al[1]);
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty + prev);
      // d[4 x + e] is s^T[j = j0 + 16 mt + g + 8 (e / 2), i = 8 x + 2 t + e % 2]
      if (wg_busy) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + mt * 16 + g + 8 * (e / 2), i = 8 * x + 2 * t + e % 2;
            if (j < sh.nj) *reinterpret_cast<float*>(s_base + i * sh.sr + j * 4) = d[4 * x + e];
          }
        }
      }
    } else {
      float acc[kPairsPerWarp][2][4] = {};
      const int p0 = pass * kPairsPerPass + quarter;
      for (int k = 0; k < kc; ++k, ++c) {
        const int s = c % stages;
        mbar_wait(full + s, (c / stages) & 1);
        score_chunk(ring + s * sh.stage, sh, mt, p0, pairs, N, lane, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
#pragma unroll
      for (int x = 0; x < kPairsPerWarp; ++x) {
        const int p = p0 + kTQ * x;
        if (p < pairs) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = mt * 16 + g + 8 * h, j = p * 16 + q * 8 + 2 * t;
              *reinterpret_cast<float2*>(s_base + i * sh.sr + j * 4) =
                  make_float2(acc[x][q][2 * h], acc[x][q][2 * h + 1]);
            }
          }
        }
      }
    }
  }
  consumers_sync();

  // alpha = softmax_j(s / sqrt(D)) in fp32, a warp a row, zero past N. bf16:
  // written in place as packed words (each lane rewrites only the words it
  // read); a row's values stay in registers up to N = 256. float32 (N <=
  // 256): each warp's rows i = w + 16 r into registers; once every warp has
  // read s, alpha's tf32 halves go over it as the weighted sum's B: block e
  // (columns 32 e..) of 64 rows x 128 bytes, 128-byte swizzle, hi blocks
  // then lo blocks (rows past the tile's are zero)
  const float scale = rsqrtf(static_cast<float>(D));
  const float neg_inf = __int_as_float(0xff800000);
  if constexpr (kF32) {
    constexpr int kRows = kTileRows / kTW;
    float v[kRows][kRowRegs];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = warp + kTW * q;
      const float* srow = reinterpret_cast<const float*>(s_base + i * sh.sr);
#pragma unroll
      for (int e = 0; e < kRowRegs; ++e) v[q][e] = 0.f;
      if (i < rows) {  // uniform across the warp
        float mx = neg_inf;
#pragma unroll
        for (int e = 0; e < kRowRegs; ++e) {
          const int j = lane + 32 * e;
          v[q][e] = j < N ? srow[j] * scale : neg_inf;
          mx = fmaxf(mx, v[q][e]);
        }
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < kRowRegs; ++e) {
          v[q][e] = lane + 32 * e < N ? expf(v[q][e] - mx) : 0.f;
          sum += v[q][e];
        }
        const float inv = 1.f / warp_sum(sum);
#pragma unroll
        for (int e = 0; e < kRowRegs; ++e) v[q][e] *= inv;
      }
    }
    consumers_sync();
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = warp + kTW * q;
#pragma unroll
      for (int e = 0; e < kRowRegs; ++e) {
        if (e < sh.nblk) {
          const size_t at = static_cast<size_t>(e) * kBlock + i * 128 +
                            (((lane / 4) ^ (i & 7)) << 4) + (lane % 4) * 4;
          float hi, lo;
          split_f32(v[q][e], hi, lo);
          *reinterpret_cast<float*>(lo_base + at) = hi;
          *reinterpret_cast<float*>(alpha_lo + at) = lo;
        }
      }
    }
    fence_async_smem();  // read next by wgmma (the async proxy)
  } else {
    for (int i = warp; i < rows; i += kTW) {
      float* srow = reinterpret_cast<float*>(s_base + i * sh.sr);
      uint32_t* arow = reinterpret_cast<uint32_t*>(srow);
      if (N <= 32 * kRowRegs) {
        float v[kRowRegs];
        float mx = neg_inf;
#pragma unroll
        for (int e = 0; e < kRowRegs; ++e) {
          const int j = lane + 32 * e;
          v[e] = j < N ? srow[j] * scale : neg_inf;
          mx = fmaxf(mx, v[e]);
        }
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < kRowRegs; ++e) {
          v[e] = lane + 32 * e < N ? expf(v[e] - mx) : 0.f;
          sum += v[e];
        }
        const float inv = 1.f / warp_sum(sum);
#pragma unroll
        for (int e = 0; e < kRowRegs; ++e) {
          const int j = lane + 32 * e;
          if (j < sh.nj) arow[j] = j < N ? pack_alpha(v[e] * inv) : 0u;
        }
      } else {
        float mx = neg_inf;
        for (int j = lane; j < N; j += 32) mx = fmaxf(mx, srow[j] * scale);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < N; j += 32) sum += expf(srow[j] * scale - mx);
        const float inv = 1.f / warp_sum(sum);
        for (int j = lane; j < sh.nj; j += 32) {
          arow[j] = j < N ? pack_alpha(expf(srow[j] * scale - mx) * inv) : 0u;
        }
      }
    }
  }
  consumers_sync();

  // out[rows, chunk] = alpha . r[:, chunk], a chunk a stage: chunk k belongs
  // to the kTQ warps of quarter k % kTQ (four chunks in flight). bf16: warp w
  // computes rows (w % 4) * 16.. over the chunk's 64 columns, alpha's
  // fragments read once a chunk, per 16 rows of j both halves of alpha
  // against one ldmatrix.trans of r for each 16-column pair; float32: the
  // quarter is a warpgroup, weighted_chunk_f32. Every warp waits for every
  // chunk and releases it (the ring's count).
  const int kts = sh.nj / 16;
  T* ob = out + (b * N + i0) * D;
  for (int k = 0; k < kc; ++k, ++c) {
    const int s = c % stages;
    mbar_wait(full + s, (c / stages) & 1);
    const unsigned r_base = smem_addr(ring + s * sh.stage + sh.pg_box);
    unsigned char* o_s = ring + s * sh.stage;  // the stage's pg box: unused by the weighted sum
    if constexpr (kF32) {
      // chunks 2p and 2p + 1 belong to warpgroup p % kTQ, which keeps the
      // first one's stage until the second one's has come (a last odd chunk
      // goes alone)
      const int owner = (k / 2) % kTQ;
      const bool last_of_pair = k % 2 == 1 || k == kc - 1;
      if (owner == quarter && last_of_pair) {
        const bool two = k % 2 == 1;
        const int s0 = two ? (c - 1) % stages : s;  // the pair's first chunk's stage
        const bool has = mt < 2 || two;
        const int mine = mt < 2 ? s0 : s, kw = mt < 2 && two ? k - 1 : k;
        unsigned char* w_s = ring + mine * sh.stage;  // this warp's chunk
        float acc[32] = {};
        weighted_chunk_f32(lo_base, alpha_lo, sh.nj / 8, smem_addr(w_s + sh.pg_box), has, N,
                           mt % 2, lane, acc);
        // acc[4 x + e] is out[i = 8 x + 2 t + e % 2, column of A row m = 16
        // (mt % 2) + g + 8 (e / 2) of this warp's chunk]
        if (has) {
#pragma unroll
          for (int x = 0; x < 8; ++x) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 8 * x + 2 * t + e % 2;
              const int piece = 2 * (mt % 2) + e / 2 + 4 * (g / 4), col = 4 * piece + g % 4;
              if (kVec) {
                *reinterpret_cast<float*>(w_s + i * 128 + ((piece ^ (i & 7)) << 4) +
                                          (g % 4) * 4) = acc[4 * x + e];
              } else if (i < rows && kw * kC + col < D) {
                ob[static_cast<int64_t>(i) * D + kw * kC + col] = acc[4 * x + e];
              }
            }
          }
        }
        if (kVec) {  // a TMA store a chunk (rows past N, columns past D clipped)
          fence_async_smem();
          group_sync(quarter);
          if (mt == 0 && lane == 0) {
            tma_store_3d(&out_map, ring + s0 * sh.stage, (two ? k - 1 : k) * kC, i0,
                         static_cast<int>(b));
            if (two) tma_store_3d(&out_map, o_s, k * kC, i0, static_cast<int>(b));
            bulk_commit_and_wait_read();
          }
        }
        __syncwarp();
        if (lane == 0 && two) mbar_arrive(empty + s0);
      }
      __syncwarp();
      if (lane == 0 && !(owner == quarter && !last_of_pair)) mbar_arrive(empty + s);
      continue;
    } else if (k % kTQ == quarter) {
      // acc[x][q] is columns 16 x + 8 q + 2 t (+1)
      float acc[kC / 16][2][4] = {};
      for (int kt = 0; kt < kts; ++kt) {  // weighted sum
        uint32_t hi[4], lo[4];
        alpha_frag(s_base, sh.sr, mt * 16, kt * 16, lane, hi, lo);
        const int j = min(kt * 16 + lane % 8 + ((lane / 8) % 2) * 8, N - 1);
#pragma unroll
        for (int x = 0; x < kC / 16; ++x) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, r_base + j * 128 + (((2 * x + lane / 16) ^ (j & 7)) << 4));
          mma_16816(acc[x][0], hi, bb[0], bb[1]);
          mma_16816(acc[x][0], lo, bb[0], bb[1]);
          mma_16816(acc[x][1], hi, bb[2], bb[3]);
          mma_16816(acc[x][1], lo, bb[2], bb[3]);
        }
      }
      if (kVec) {
        // the chunk's output into the stage's pg box, 128-byte swizzled,
        // then one TMA store of it by the group (rows past N and columns
        // past D clipped by the map)
#pragma unroll
        for (int x = 0; x < kC / 16; ++x) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rho = mt * 16 + g + 8 * h, kq = 2 * x + q;
              *reinterpret_cast<__nv_bfloat162*>(o_s + rho * 128 + ((kq ^ (rho & 7)) << 4) +
                                                 4 * t) =
                  __floats2bfloat162_rn(acc[x][q][2 * h], acc[x][q][2 * h + 1]);
            }
          }
        }
        fence_async_smem();
        group_sync(quarter);
        if (mt == 0 && lane == 0) {
          tma_store_3d(&out_map, o_s, k * kC, i0, static_cast<int>(b));
          bulk_commit_and_wait_read();
        }
      } else {
#pragma unroll
        for (int x = 0; x < kC / 16; ++x) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = mt * 16 + g + 8 * h, d = k * kC + x * 16 + q * 8 + 2 * t;
              const bool store_ok = i < rows && d < D;
              if (store_ok) {
                store_pair(ob + static_cast<int64_t>(i) * D + d, acc[x][q][2 * h],
                           acc[x][q][2 * h + 1], d + 1 < D);
              }
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
}

// ---------------------------------------------------------- wide design

// The parent's N > 64 kernel, kept for N past what the tiled design takes
// (bf16: its s [64, N] and a stage of N rows of r, N > ~570; float32: N >
// 256): one block per (element, 16 rows of i); the tile's pg rows in
// shared memory; one warp per column j computes that column's 16 scores in
// fp32 (lanes over D, 16-byte loads of r[j] from L2, a shuffle reduction)
// into s^T [N, 16]; the softmax a warp a row in place; the weighted sum
// streams r again, each thread owning 4 columns of the 16 output rows. Its
// only limit is shared memory: 32 D + 64 N bytes (bf16). Simple and slow
// (4.8% of its bound at N=196), for shapes nothing else takes. kSplit: the
// split design (the file's head), the same steps over one chunk of r's
// rows, its partials unnormalised into scratch for lse_merge.cuh.

constexpr int kWideRows = 16;  // rows of i a block of the wide design owns

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// the wide design's element access, bf16 or float32 alike: 8 consecutive
// elements (16-byte aligned) into fp32, 4 (8 or 16 bytes), and one
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  Pack8 q;
  q.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(q.h[e]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } q;
  q.u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(q.h[0]), hi = __bfloat1622float2(q.h[1]);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}


// 16 rows of pg and s^T [rows, 16] (fp32): rows = N in the wide design,
// the chunk in the split one
template <typename T>
size_t wide_smem(int rows, int D) {
  return align16(static_cast<size_t>(kWideRows) * D * sizeof(T)) +
         static_cast<size_t>(rows) * kWideRows * sizeof(float);
}

template <typename T, bool kVec, bool kSplit>
__global__ void __launch_bounds__(kThreads)
relation_wide_kernel(const T* __restrict__ pg, const T* __restrict__ r,
                      T* __restrict__ out, float* __restrict__ part, float* __restrict__ stats,
                      int N, int D, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* pg_s = reinterpret_cast<T*>(smem);  // [16, D], zero rows past the tile
  float* a_s =  // s^T [chunk, 16]
      reinterpret_cast<float*>(smem + align16(static_cast<size_t>(kWideRows) * D * sizeof(T)));
  const int n_tiles = (N + kWideRows - 1) / kWideRows;
  // the split design: chunk c of r's rows, [j0, j0 + nj); the wide one: all N
  const int n_chunks = kSplit ? ceil_div(N, chunk) : 1;
  const int c = kSplit ? static_cast<int>(blockIdx.x % n_chunks) : 0;
  const int64_t tile = kSplit ? blockIdx.x / n_chunks : blockIdx.x;
  const int64_t b = tile / n_tiles;
  const int i0 = static_cast<int>(tile % n_tiles) * kWideRows;
  const int ni = min(kWideRows, N - i0);
  const int j0 = c * chunk;
  const int nj = kSplit ? min(chunk, N - j0) : N;
  const int64_t nd = static_cast<int64_t>(N) * D;
  const T* pgb = pg + b * nd + static_cast<int64_t>(i0) * D;
  const T* rb = r + b * nd + static_cast<int64_t>(j0) * D;
  T* ob = out + b * nd + static_cast<int64_t>(i0) * D;
  const int64_t row0 = b * N + i0;  // the split design's first row of part and stats
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte piece
    const int n_col = D / kPer;
    for (int i = tid; i < kWideRows * n_col; i += kThreads) {
      const int row = i / n_col, col = (i % n_col) * kPer;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < ni) x = *reinterpret_cast<const uint4*>(pgb + static_cast<int64_t>(row) * D + col);
      *reinterpret_cast<uint4*>(pg_s + row * D + col) = x;
    }
  } else {
    for (int i = tid; i < kWideRows * D; i += kThreads) {
      const int row = i / D;
      pg_s[i] = row < ni ? pgb[static_cast<int64_t>(row) * D + i % D] : from_float<T>(0.f);
    }
  }
  __syncthreads();

  // s^T[j, i] = <pg_i, r_j>, one warp per column j, all 16 rows at once
  for (int j = warp; j < nj; j += kWarps) {
    const T* rj = rb + static_cast<int64_t>(j) * D;
    float acc[kWideRows] = {};
    if (kVec) {
#pragma unroll 2
      for (int d = lane * 8; d < D; d += 32 * 8) {
        float xf[8];
        load8(rj + d, xf);
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) {
          float q[8];
          load8(pg_s + i * D + d, q);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i] += q[e] * xf[e];
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float x = to_float(rj[d]);
#pragma unroll
        for (int i = 0; i < kWideRows; ++i) acc[i] += to_float(pg_s[i * D + d]) * x;
      }
    }
    float mine = 0.f;  // lane i keeps row i's sum (no register array indexed at run time)
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const float t = warp_sum(acc[i]);
      if (lane == i) mine = t;
    }
    if (lane < kWideRows) a_s[j * kWideRows + lane] = mine;
  }
  __syncthreads();

  // alpha = softmax_j(s / sqrt(D)) in fp32, one warp per row, in place; the
  // split design keeps exp(s / sqrt(D) - m_c) unnormalised and writes the
  // chunk's (m_c, l_c) for the merge
  const float scale = rsqrtf(static_cast<float>(D));
  const float neg_inf = __int_as_float(0xff800000);
  for (int i = warp; i < kWideRows; i += kWarps) {
    float mx = neg_inf;
    for (int j = lane; j < nj; j += 32) mx = fmaxf(mx, a_s[j * kWideRows + i] * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nj; j += 32) sum += expf(a_s[j * kWideRows + i] * scale - mx);
    sum = warp_sum(sum);
    const float inv = kSplit ? 1.f : 1.f / sum;
    for (int j = lane; j < nj; j += 32) {
      a_s[j * kWideRows + i] = expf(a_s[j * kWideRows + i] * scale - mx) * inv;
    }
    if (kSplit && lane == 0 && i < ni) {
      *reinterpret_cast<float2*>(stats + ((row0 + i) * n_chunks + c) * 2) = make_float2(mx, sum);
    }
  }
  __syncthreads();

  // out[i, d..d+W) = sum_j alpha[i, j] * r[j, d..d+W) for the 16 rows (the
  // split design: the chunk's partial, fp32, into part)
  constexpr int W = kVec ? 4 : 1;
  for (int d = tid * W; d < D; d += kThreads * W) {
    float acc[kWideRows][W] = {};
#pragma unroll 4
    for (int j = 0; j < nj; ++j) {
      float x[W];
      if constexpr (kVec) {
        load4(rb + static_cast<int64_t>(j) * D + d, x);
      } else {
        x[0] = to_float(rb[static_cast<int64_t>(j) * D + d]);
      }
      const float4* al = reinterpret_cast<const float4*>(a_s + j * kWideRows);
#pragma unroll
      for (int q = 0; q < kWideRows / 4; ++q) {
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
    for (int i = 0; i < kWideRows; ++i) {
      if (i < ni) {
        if constexpr (kSplit) {
          float* p = part + ((row0 + i) * n_chunks + c) * D + d;
          if constexpr (kVec) {
            *reinterpret_cast<float4*>(p) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          } else {
            p[0] = acc[i][0];
          }
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            ob[static_cast<int64_t>(i) * D + d + e] = from_float<T>(acc[i][e]);
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

// [B * N rows, D columns] of T in boxes of `rows` x one 128-byte row (64
// bf16 or 32 float32 columns), 128-byte swizzle, zero past either end
template <typename T>
cudaError_t encode_rows(CUtensorMap* map, const void* base, int B, int N, int D, int rows) {
  EncodeFn encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B) * static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(T)};
  const cuuint32_t box[2] = {kChunk<T>, static_cast<cuuint32_t>(rows)};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// [B, N, D] of T in boxes of 64 rows x one 128-byte row of one element,
// 128-byte swizzle: a store clips at the element's last row
template <typename T>
cudaError_t encode_out(CUtensorMap* map, void* base, int B, int N, int D) {
  EncodeFn encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * sizeof(T),
                                 static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(D) *
                                     sizeof(T)};
  const cuuint32_t box[3] = {kChunk<T>, kTileRows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             3, base, dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// what a launch of `design` runs in elements of `elem` bytes: CTAs, cluster
// size, threads, shared memory of a CTA; cudaErrorInvalidValue for a
// schedule the design cannot run
struct Geometry {
  long long ctas, cluster, threads, smem;
};

cudaError_t geometry(int B, int N, int D, int design, int split, int stages, bool vec, int elem,
                     Geometry* g) {
  if (design == kDesignElement) {
    if (elem != 2 || N > kMaxN || split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
    if (split > 1 && (!vec || D % (16 * split) != 0 || D / split < kMinCols))
      return cudaErrorInvalidValue;
    *g = {static_cast<long long>(B) * split, split, 32 * kEW,
          static_cast<long long>(shape_of(N, D, split).total)};
    return cudaSuccess;
  }
  if (design == kDesignTiled) {
    if (stages < 1 || stages > kMaxStages || static_cast<long long>(B) * N >= (1LL << 31) ||
        (elem == 4 && N > kMaxF32N))
      return cudaErrorInvalidValue;
    *g = {static_cast<long long>(B) * ceil_div(N, kTileRows), 1, 32 * kTW + 32,
          static_cast<long long>(tiled_smem(N, stages, elem))};
    return cudaSuccess;
  }
  if (design == kDesignWide) {
    *g = {static_cast<long long>(B) * ceil_div(N, kWideRows), 1, kThreads,
          static_cast<long long>(elem == 2 ? wide_smem<bf16>(N, D) : wide_smem<float>(N, D))};
    return cudaSuccess;
  }
  if (design == kDesignSplit) {  // `split`: the chunks of r's rows
    if (split < 1 || split > N || split > lse::kMaxMergeChunks) return cudaErrorInvalidValue;
    const int chunk = ceil_div(N, split);
    if (ceil_div(N, chunk) != split) return cudaErrorInvalidValue;
    *g = {static_cast<long long>(B) * ceil_div(N, kWideRows) * split, 1, kThreads,
          static_cast<long long>(elem == 2 ? wide_smem<bf16>(chunk, D)
                                           : wide_smem<float>(chunk, D))};
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool vec_of(const void* pg, const void* r, const void* out, int D) {
  return D % 8 == 0 && (reinterpret_cast<uintptr_t>(pg) | reinterpret_cast<uintptr_t>(r) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
}

template <typename T>
cudaError_t launch_tiled(const T* pg, const T* r, T* out, int B, int N, int D, int stages,
                         bool vec, cudaLaunchConfig_t& cfg) {
  auto kernel = vec ? relation_tiled_kernel<T, true> : relation_tiled_kernel<T, false>;
  cudaError_t err = opt_in(kernel, static_cast<long long>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  CUtensorMap pg_map = {}, r_map = {}, out_map = {};  // unused by the plain copies
  if (vec) {
    const TiledShape sh = tiled_shape(N, sizeof(T));
    err = encode_rows<T>(&pg_map, pg, B, N, D, kTileRows);
    if (err == cudaSuccess) err = encode_rows<T>(&r_map, r, B, N, D, sh.rb);
    if (err == cudaSuccess) err = encode_out<T>(&out_map, out, B, N, D);
    if (err != cudaSuccess) return err;
  }
  return cudaLaunchKernelEx(&cfg, kernel, pg_map, r_map, out_map, pg, r, out, N, D, stages);
}

template <typename T>
cudaError_t launch_wide(const T* pg, const T* r, T* out, int N, int D, bool vec,
                        cudaLaunchConfig_t& cfg) {
  auto kernel = vec ? relation_wide_kernel<T, true, false> : relation_wide_kernel<T, false, false>;
  const cudaError_t err = opt_in(kernel, static_cast<long long>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, pg, r, out, static_cast<float*>(nullptr),
                            static_cast<float*>(nullptr), N, D, N);
}

// the split design: the chunks' partials into part and stats, then the merge
template <typename T>
int launch_split(const void* pg, const void* r, void* out, void* part, void* stats, int B, int N,
                 int D, int chunks, cudaStream_t s) {
  const bool vec = vec_of(pg, r, part, D);
  Geometry geo;
  cudaError_t err = geometry(B, N, D, kDesignSplit, chunks, 1, vec, sizeof(T), &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (geo.ctas >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec ? relation_wide_kernel<T, true, true> : relation_wide_kernel<T, false, true>;
  err = opt_in(kernel, geo.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* op = static_cast<T*>(out);
  auto* pp = static_cast<float*>(part);
  auto* sp = static_cast<float*>(stats);
  kernel<<<static_cast<unsigned>(geo.ctas), static_cast<unsigned>(geo.threads),
           static_cast<size_t>(geo.smem), s>>>(static_cast<const T*>(pg),
                                                 static_cast<const T*>(r), op, pp, sp, N, D,
                                                 ceil_div(N, chunks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(lse::merge<T>(pp, sp, op, static_cast<int64_t>(B) * N, chunks, D, s));
}

int launch(const void* pg, const void* r, void* out, int B, int N, int D, int design, int split,
           int stages, cudaStream_t s) {
  if (design == kDesignSplit) return static_cast<int>(cudaErrorInvalidValue);  // its own entry
  const bool vec = vec_of(pg, r, out, D);
  Geometry geo;
  cudaError_t err = geometry(B, N, D, design, split, stages, vec, 2, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* pp = static_cast<const bf16*>(pg);
  auto* rp = static_cast<const bf16*>(r);
  auto* op = static_cast<bf16*>(out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(geo.ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(geo.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(geo.smem);
  cfg.stream = s;
  if (design == kDesignElement) {
    auto kernel = vec ? relation_element_kernel<true> : relation_element_kernel<false>;
    err = opt_in(kernel, geo.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = split > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, pp, rp, op, N, D, split);
  } else if (design == kDesignWide) {
    err = launch_wide(pp, rp, op, N, D, vec, cfg);
  } else {
    err = launch_tiled(pp, rp, op, B, N, D, stages, vec, cfg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the float32 entry: the tiled or the wide design on float32 operands
int launch_f32(const void* pg, const void* r, void* out, int B, int N, int D, int design,
               int stages, cudaStream_t s) {
  if (design != kDesignTiled && design != kDesignWide) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_of(pg, r, out, D);
  Geometry geo;
  cudaError_t err = geometry(B, N, D, design, 1, stages, vec, 4, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (geo.ctas >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto* pp = static_cast<const float*>(pg);
  auto* rp = static_cast<const float*>(r);
  auto* op = static_cast<float*>(out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(geo.ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(geo.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(geo.smem);
  cfg.stream = s;
  err = design == kDesignTiled ? launch_tiled(pp, rp, op, B, N, D, stages, vec, cfg)
                               : launch_wide(pp, rp, op, N, D, vec, cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of `design` (0: element, 1: tiled, 2: wide; 3, split, has its
// own entry below) with `split` CTAs
// an element (element) or `stages` ring stages (tiled), as
// ops/relation.py::relation_plan gives them, on `stream`. Returns the
// launch's cudaError_t, or 0.
extern "C" int vqa_relation_attend(const void* pg, const void* r, void* out, int B, int N, int D,
                                   int design, int split, int stages, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  return launch(pg, r, out, B, N, D, design, split, stages, static_cast<cudaStream_t>(stream));
}

// relation_attend in float32 (pg, r and out float32) on `stream`: `design`
// 1 (tiled: both products in 3xTF32, N <= 256) with `stages` ring stages,
// or 2 (wide: FP32 FMA), as ops/relation.py::relation_plan with 4-byte
// elements gives them. Returns the launch's cudaError_t, or 0.
extern "C" int vqa_relation_attend_f32(const void* pg, const void* r, void* out, int B, int N,
                                       int D, int design, int stages, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  return launch_f32(pg, r, out, B, N, D, design, stages, static_cast<cudaStream_t>(stream));
}

// relation_attend by the split design (3), in bf16 (`elem` 2) or float32
// (`elem` 4) on `stream`: `chunks` chunks of r's rows, each chunk's fp32
// partial output into part [B N, chunks, D] and its (max, sum of exp) into
// stats [B N, chunks, 2] (scratch the caller allocates), then their merge
// into out. Returns the first failing launch's cudaError_t, or 0.
extern "C" int vqa_relation_attend_split(const void* pg, const void* r, void* out, void* part,
                                         void* stats, int B, int N, int D, int chunks, int elem,
                                         void* stream) {
  if (B <= 0 || N <= 0 || D <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem == 2) return launch_split<bf16>(pg, r, out, part, stats, B, N, D, chunks, s);
  if (elem == 4) return launch_split<float>(pg, r, out, part, stats, B, N, D, chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What vqa_relation_attend (`elem` 2) or vqa_relation_attend_f32 (`elem` 4)
// (or vqa_relation_attend_split, `design` 3 with `split` its chunks)
// launches for this schedule (its own reckoning): geometry[0] the CTAs, [1]
// the cluster size, [2] the threads of a CTA, [3] its shared memory. Returns
// a cudaError_t.
extern "C" int vqa_relation_geometry(int B, int N, int D, int design, int split, int stages,
                                     int vec, int elem, long long* geometry_out) {
  if (elem != 2 && elem != 4) return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo;
  const cudaError_t err = geometry(B, N, D, design, split, stages, vec != 0, elem, &geo);
  if (err != cudaSuccess) return static_cast<int>(err);
  geometry_out[0] = geo.ctas;
  geometry_out[1] = geo.cluster;
  geometry_out[2] = geo.threads;
  geometry_out[3] = geo.smem;
  return 0;
}
