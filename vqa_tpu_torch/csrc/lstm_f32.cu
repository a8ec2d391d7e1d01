// lstm_seq forward in float32: the masked LSTM recurrence over precomputed
// input gates, every operand, output and carry in float32.
//
//   xg [T, B, 4H], mask [T, B, 1], wh [H, 4H] (float32, gates i, f, g, o)
//   -> h_last [B, H] (the frozen carry), seq [T, B, H] (new_h * mask)
//
// Replaces vqa_tpu/ops/lstm.py::_lstm_seq_pallas (_pallas_fwd, _kernel) on
// float32 inputs. The Pallas kernel computes in xg's dtype: its outputs and
// its h / c scratch take xg.dtype, so in float32 nothing is rounded between
// steps. Here h and c stay float32 from step to step, the product is float32
// arithmetic (FP32 FMA on the CUDA cores: single-pass TF32 would keep about
// three decimal digits, and is not float32), and the gate math is fp32
// (expf, tanhf, IEEE division) as the plain version's torch.sigmoid/tanh.
//
// What bounds it on the H100: the products. Each step after the first is
// h[B, H] x wh[H, 4H]: at B=1024, H=2400, 47.2 GFLOP a step, 1.2268 TFLOP
// over T=26 (25 products), 18.3 ms at the card's 67 TFLOP/s FP32 peak; the
// bytes (xg and seq, 0.51 GB at T=26) take 0.15 ms at 3.35 TB/s.
//
// The design: the bf16 kernel's plan (csrc/lstm.cu) with the tensor-core
// machinery taken out; the first right float32 kernel, not yet a fast one.
//   - tile: 128 batch rows x 32 hidden units of all four gates, a product
//     tile of 128 columns read at columns g*Gs + u0 of the flax-layout wh
//     (ops/lstm.py::gate_strips: Gs a multiple of 8, so each gate strip's
//     16-byte loads stay inside it); no weight permutation.
//   - product: 256 threads, each 8 rows x (2 units x 4 gates), from K tiles
//     of 16 double-buffered in shared memory (h transposed, wh as it lies),
//     the next tile's loads in flight in registers while the current one is
//     multiplied; one barrier a K tile.
//   - epilogue: a thread holds all four gates of its (row, unit) pairs, so
//     it adds xg_t, runs the gate math, blends by the mask and writes h, c
//     and seq_t two units at a time (8-byte accesses: H even, and
//     ops/lstm.py::pad_odd_hidden pads an odd H with one exact zero unit).
//   - steps chained on the card: ONE persistent launch runs all T steps.
//     Every CTA owns the same tiles every step (tile = blockIdx.x + k *
//     gridDim.x, row tiles fastest so that concurrent CTAs share each wh
//     strip in L2), so its threads alone read and write their c; h goes
//     through two ping-pong buffers, read with ld.global.cg (L2, not a stale
//     L1 line), and a grid barrier (a counter in global memory, release add
//     and acquire spin) separates the steps. The launch is cooperative, so a
//     grid that cannot be co-resident is refused instead of hanging; the
//     grid is the tiles or the co-resident CTAs, the fewer. Step 0 has no
//     product (h and c start at zero). No atomics touch the data: two calls
//     give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;        // batch rows a tile
constexpr int kBU = 32;         // hidden units a tile
constexpr int kBN = 4 * kBU;    // product columns a tile: the four gate strips
constexpr int kBK = 16;         // K a shared-memory stage
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 products each
constexpr int kLdA = kBM + 4;   // h^T's row stride: 16-byte rows, spread banks
constexpr int kMinBlocks = 2;   // CTAs an SM is built for (registers <= 128)

struct Args {
  const float* xg;    // [T, B, 4H]
  const float* mask;  // [T, B]
  const float* wh;    // [H, 4 Gs]
  float* h_last;      // [B, H]
  float* seq;         // [T, B, H]
  float* hbuf;        // [2, B, Hp] ping-pong h of the steps
  float* c;           // [B, Hp]
  unsigned* count;    // zeroed before the launch: the grid barrier
  int T, B, H, Hp, Gs;
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

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

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads, kMinBlocks) lstm_f32_kernel(const Args a) {
  __shared__ __align__(16) float As[2][kBK][kLdA];  // h^T: [k][row]
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // wh: [k][gate * kBU + unit]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_rt = ceil_div(a.B, kBM);
  const int n_tiles = n_rt * ceil_div(a.H, kBU);
  const int n_k = ceil_div(a.H, kBK);
  const int64_t g4 = 4LL * a.H, w4 = 4LL * a.Gs, plane = static_cast<int64_t>(a.B) * a.Hp;

  for (int t = 0; t < a.T; ++t) {
    const float* h_in = a.hbuf + (t & 1) * plane;
    float* h_out = a.hbuf + ((t + 1) & 1) * plane;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = (tile % n_rt) * kBM, u0 = (tile / n_rt) * kBU;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      if (t > 0) {  // step 0's h is zero: no product
        float4 ra[2], rb[2];
        // K tile kt into registers: h[r0 + tid/4 + 64 i, k0 + 4 (tid%4) ..]
        // (zero past B and H), and wh's rows k0.. of the tile's 4 strips
        auto load = [&](int kt) {
          const int k0 = kt * kBK;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r0 + tid / 4 + 64 * i, kq = k0 + (tid % 4) * 4;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (row < a.B) {
              const float* p = h_in + static_cast<int64_t>(row) * a.Hp + kq;
              if (kq + 3 < a.H) {
                x = __ldcg(reinterpret_cast<const float4*>(p));
              } else {
                if (kq < a.H) x.x = __ldcg(p);
                if (kq + 1 < a.H) x.y = __ldcg(p + 1);
                if (kq + 2 < a.H) x.z = __ldcg(p + 2);
              }
            }
            ra[i] = x;
            const int idx = tid + kThreads * i;
            const int k = k0 + idx / 32, g = (idx % 32) / 8, uq = u0 + (idx % 8) * 4;
            float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
            if (k < a.H && uq < a.Gs) {
              y = __ldg(reinterpret_cast<const float4*>(a.wh + k * w4 + g * a.Gs + uq));
            }
            rb[i] = y;
          }
        };
        auto store = [&](int buf) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = tid / 4 + 64 * i, kq = (tid % 4) * 4;
            As[buf][kq][row] = ra[i].x;
            As[buf][kq + 1][row] = ra[i].y;
            As[buf][kq + 2][row] = ra[i].z;
            As[buf][kq + 3][row] = ra[i].w;
            const int idx = tid + kThreads * i;
            *reinterpret_cast<float4*>(&Bs[buf][idx / 32][(idx % 32) * 4]) = rb[i];
          }
        };
        load(0);
        store(0);
        __syncthreads();
        for (int kt = 0; kt < n_k; ++kt) {
          const int buf = kt & 1;
          if (kt + 1 < n_k) load(kt + 1);
#pragma unroll
          for (int kk = 0; kk < kBK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            float bv[8];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float2 q = *reinterpret_cast<const float2*>(&Bs[buf][kk][g * kBU + tx * 2]);
              bv[2 * g] = q.x;
              bv[2 * g + 1] = q.y;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
          if (kt + 1 < n_k) store(buf ^ 1);
          __syncthreads();
        }
      }

      // epilogue: rows ty*4 + i and 64 + ty*4 + i, units u and u + 1 (H is
      // even and u is even, so both or neither are real units)
      const int u = u0 + tx * 2;
      if (u < a.H) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
          if (row >= a.B) continue;
          const int64_t bt = static_cast<int64_t>(t) * a.B + row;
          const float* xr = a.xg + bt * g4 + u;
          const float2 xi = *reinterpret_cast<const float2*>(xr);
          const float2 xf = *reinterpret_cast<const float2*>(xr + a.H);
          const float2 xc = *reinterpret_cast<const float2*>(xr + 2 * a.H);
          const float2 xo = *reinterpret_cast<const float2*>(xr + 3 * a.H);
          const float m = a.mask[bt];
          const int64_t at = static_cast<int64_t>(row) * a.Hp + u;
          float2 c_prev = make_float2(0.f, 0.f), h_prev = make_float2(0.f, 0.f);
          if (t > 0) {
            c_prev = __ldcg(reinterpret_cast<const float2*>(a.c + at));
            h_prev = __ldcg(reinterpret_cast<const float2*>(h_in + at));
          }
          const float pre_i[2] = {acc[i][0] + xi.x, acc[i][1] + xi.y};
          const float pre_f[2] = {acc[i][2] + xf.x, acc[i][3] + xf.y};
          const float pre_g[2] = {acc[i][4] + xc.x, acc[i][5] + xc.y};
          const float pre_o[2] = {acc[i][6] + xo.x, acc[i][7] + xo.y};
          const float cp[2] = {c_prev.x, c_prev.y}, hp[2] = {h_prev.x, h_prev.y};
          float c_new[2], h_new[2], c_keep[2], h_keep[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            c_new[e] = sigmoid(pre_f[e]) * cp[e] + sigmoid(pre_i[e]) * tanhf(pre_g[e]);
            h_new[e] = sigmoid(pre_o[e]) * tanhf(c_new[e]);
            c_keep[e] = m != 0.f ? c_new[e] : cp[e];
            h_keep[e] = m != 0.f ? h_new[e] : hp[e];
          }
          *reinterpret_cast<float2*>(a.c + at) = make_float2(c_keep[0], c_keep[1]);
          if (t + 1 < a.T) {
            *reinterpret_cast<float2*>(h_out + at) = make_float2(h_keep[0], h_keep[1]);
          } else {
            *reinterpret_cast<float2*>(a.h_last + static_cast<int64_t>(row) * a.H + u) =
                make_float2(h_keep[0], h_keep[1]);
          }
          *reinterpret_cast<float2*>(a.seq + bt * a.H + u) =
              make_float2(h_new[0] * m, h_new[1] * m);
        }
      }
    }
    if (t + 1 < a.T) {  // every CTA's h of step t before any reads it
      __syncthreads();
      if (tid == 0) {
        release_add(a.count);
        acquire_wait(a.count, static_cast<unsigned>(t + 1) * gridDim.x);
      }
      __syncthreads();
    }
  }
}

// the grid (every CTA co-resident: the grid barrier waits on all of them),
// the tiles a step and the shared memory of a CTA
cudaError_t geometry(int B, int H, long long* grid, long long* tiles, long long* smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_f32_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const long long n_tiles = static_cast<long long>(ceil_div(B, kBM)) * ceil_div(H, kBU);
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  *grid = n_tiles < resident ? n_tiles : resident;
  *tiles = n_tiles;
  *smem = static_cast<long long>(sizeof(float)) * 2 * kBK * (kLdA + kBN);
  return cudaSuccess;
}

int launch(const void* xg, const void* mask, const void* wh, void* h_last, void* seq, void* hbuf,
           void* c, void* count, int T, int B, int H, int gs, cudaStream_t s) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  // the epilogue moves two units at a time; a strip's 16-byte loads stay in it
  if (H % 2 != 0 || gs % 4 != 0 || gs < H) return static_cast<int>(cudaErrorInvalidValue);
  long long grid = 0, tiles = 0, smem = 0;
  cudaError_t err = geometry(B, H, &grid, &tiles, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const float*>(xg), static_cast<const float*>(mask),
         static_cast<const float*>(wh), static_cast<float*>(h_last), static_cast<float*>(seq),
         static_cast<float*>(hbuf), static_cast<float*>(c), static_cast<unsigned*>(count),
         T, B, H, (H + 7) / 8 * 8, gs};
  err = cudaMemsetAsync(a.count, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // co-resident, or refused
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_f32_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs all T steps in one launch on `stream`, every pointer float32 (mask
// [T, B, 1] too). wh's rows hold four gate strips `gs` elements apart (gs =
// H, or H rounded up to 8 in a zero-padded copy: ops/lstm.py::gate_strips).
// H even (ops/lstm.py::pad_odd_hidden). hbuf is [2, B, Hp] and c [B, Hp]
// scratch (Hp = H rounded up to 8), count one uint32 of scratch. Returns the
// first non-zero cudaError_t, or 0.
extern "C" int vqa_lstm_seq_f32(const void* xg, const void* mask, const void* wh, void* h_last,
                                void* seq, void* hbuf, void* c, void* count, int T, int B, int H,
                                int gs, void* stream) {
  return launch(xg, mask, wh, h_last, seq, hbuf, c, count, T, B, H, gs,
                static_cast<cudaStream_t>(stream));
}

// What vqa_lstm_seq_f32 launches at this shape on this card (its occupancy
// decides): geometry[0] the CTAs, [1] the tiles a step, [2] the shared
// memory of a CTA. Returns a cudaError_t.
extern "C" int vqa_lstm_seq_f32_geometry(int B, int H, long long* out) {
  return static_cast<int>(geometry(B, H, &out[0], &out[1], &out[2]));
}
