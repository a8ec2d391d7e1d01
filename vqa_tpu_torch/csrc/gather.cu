// gather_rows: out[b] = table[idx[b]] for a row-major table [N, ...].
// gather_rows_dequant: out[b] = float(values[idx[b]]) * scales[idx[b]] for an
// int8 table [N, ..., D] with per-segment scales [N, ..., 1], rounded once to
// the scales' dtype (bf16 or f32), as values.to(s.dtype) * s rounds it.
//
// Replaces vqa_tpu/ops/gather.py::_gather_rows_pallas (_pallas_fwd, _kernel,
// _make_multi_kernel): the scalar-prefetched row gather of the device-resident
// feature table that the eval step runs (engine/steps.py::_resolve_visual),
// and, for an int8 table, the dequant that follows it there
// (v.astype(s.dtype) * s, vqa_tpu/engine/steps.py:69-73), fused into the
// gather so that only int8 bytes are read.
//
// What bounds it on the H100: memory traffic only. At the flagship shape
// (B=1024 rows of 36x2048 bf16 = 147,456 bytes each) gather_rows reads and
// writes ~151 MB each way, a 0.090 ms floor at 3.35 TB/s; the int8 gather
// reads 75.5 MB and writes 151 MB of bf16, a 0.068 ms floor.
//
// What the design does about it:
// - a grid of (row, chunk) blocks, row index fastest, as PyTorch's own
//   vectorized gather orders it: one sweep over the batch touches one 8 KB
//   chunk of every row (8 MB at B=1024), so a row repeated in the batch
//   (several questions about one image) is read from L2, not from device
//   memory. The
//   row-major order of the first design lost ~10% to this at B=1024;
// - every thread issues its 2 loads of 16 bytes before its stores;
//   neighbouring threads on neighbouring addresses. With ~36k blocks in the
//   grid the bytes in flight come from the resident blocks: 1, 2 and 4 loads
//   a thread measured within 1% of each other, 2 the best (PERF.md);
// - the int8 kernel loads the int8 values of 16 output bytes per step (8 for
//   bf16 out, 4 for f32), so its stores are 16 bytes wide and coalesced too;
// - the row indices ride in the kernel's parameters (up to 2048 per launch,
//   8 KB), so no host-to-device copy is issued: the host checks their range
//   before the launch (ops/gather.py).
// A persistent grid of TMA bulk copies (cp.async.bulk global->shared->global,
// 2-8 stages of 16-32 KB per block) measured 5% slower than register copies
// in the same row-major order, and 18% slower than this design (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;         // loads in flight per thread
constexpr int64_t kMaxChunks = 65535;  // gridDim.y
// Rows per launch: ops/gather.py's ROWS_PER_LAUNCH splits larger batches.
constexpr int kMaxRows = 2048;
struct RowIndex {
  int32_t v[kMaxRows];
};

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Unit* __restrict__ table, const __grid_constant__ RowIndex idx,
                   Unit* __restrict__ out, int64_t row_units) {
  const int64_t b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * (kThreads * kUnroll) + threadIdx.x;
  const Unit* src = table + idx.v[b] * row_units;
  Unit* dst = out + b * row_units;
  Unit r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < row_units) r[u] = __ldg(src + i);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < row_units) dst[i] = r[u];
  }
}

template <typename Unit>
int launch_gather(const void* table, const RowIndex& idx, void* out, int64_t n_out,
                  int64_t row_bytes, cudaStream_t stream) {
  const int64_t row_units = row_bytes / static_cast<int64_t>(sizeof(Unit));
  const int64_t chunks = (row_units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<Unit>
      <<<dim3(static_cast<unsigned>(n_out), static_cast<unsigned>(chunks)), kThreads, 0, stream>>>(
          static_cast<const Unit*>(table), idx, static_cast<Unit*>(out), row_units);
  return 0;
}

// --------------------------------------------------------- int8 + dequant
__device__ __forceinline__ float scale_of(const __nv_bfloat16* s) {
  return __bfloat162float(__ldg(s));
}
__device__ __forceinline__ float scale_of(const float* s) { return __ldg(s); }

// byte j of w as a signed value; exact in float (|v| <= 127)
__device__ __forceinline__ float lane(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// One thread-step: the int8 values of 16 output bytes, all in one segment,
// so one scale; each product is rounded once to Out.
template <typename Out>
struct Group;
template <>
struct Group<__nv_bfloat16> {
  using In = uint2;
  static constexpr int kValues = 8;
  __device__ static uint4 dequant(uint2 v, float s) {
    return make_uint4(bf16x2(lane(v.x, 0) * s, lane(v.x, 1) * s),
                      bf16x2(lane(v.x, 2) * s, lane(v.x, 3) * s),
                      bf16x2(lane(v.y, 0) * s, lane(v.y, 1) * s),
                      bf16x2(lane(v.y, 2) * s, lane(v.y, 3) * s));
  }
};
template <>
struct Group<float> {
  using In = uint32_t;
  static constexpr int kValues = 4;
  __device__ static uint4 dequant(uint32_t v, float s) {
    return make_uint4(__float_as_uint(lane(v, 0) * s), __float_as_uint(lane(v, 1) * s),
                      __float_as_uint(lane(v, 2) * s), __float_as_uint(lane(v, 3) * s));
  }
};

// D % kValues == 0 and aligned pointers: kUnroll groups per thread.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
gather_dequant_kernel(const typename Group<Out>::In* __restrict__ values,
                      const Out* __restrict__ scales, const __grid_constant__ RowIndex idx,
                      uint4* __restrict__ out, int row_groups, int seg_groups, int segs) {
  using G = Group<Out>;
  const int b = blockIdx.x;
  const int base = blockIdx.y * (kThreads * kUnroll) + threadIdx.x;
  const int64_t row = idx.v[b];
  const typename G::In* src = values + row * row_groups;
  const Out* sc = scales + row * segs;
  uint4* dst = out + static_cast<int64_t>(b) * row_groups;
  typename G::In v[kUnroll];
  float s[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * kThreads;
    if (i < row_groups) {
      v[u] = __ldg(src + i);
      s[u] = scale_of(sc + i / seg_groups);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = base + u * kThreads;
    if (i < row_groups) dst[i] = G::dequant(v[u], s[u]);
  }
}

__device__ __forceinline__ void put1(__nv_bfloat16* dst, int8_t v, float s) {
  *dst = __float2bfloat16_rn(static_cast<float>(v) * s);
}
__device__ __forceinline__ void put1(float* dst, int8_t v, float s) {
  *dst = static_cast<float>(v) * s;
}

// Any D and alignment: one value per thread.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
gather_dequant_any(const int8_t* __restrict__ values, const Out* __restrict__ scales,
                   const __grid_constant__ RowIndex idx, Out* __restrict__ out, int64_t row_len,
                   int64_t d, int64_t segs) {
  const int64_t b = blockIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (i >= row_len) return;
  const int64_t row = idx.v[b];
  put1(out + b * row_len + i, values[row * row_len + i], scale_of(scales + row * segs + i / d));
}

template <typename Out>
int launch_dequant(const void* values, const void* scales, const RowIndex& idx, void* out,
                   int64_t n_out, int64_t segs, int64_t d, cudaStream_t stream) {
  using G = Group<Out>;
  const Out* sc = static_cast<const Out*>(scales);
  const int64_t row_len = segs * d;
  if (d % G::kValues == 0 && reinterpret_cast<uintptr_t>(values) % sizeof(typename G::In) == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 && row_len < (int64_t(1) << 30)) {
    const int64_t row_groups = row_len / G::kValues;
    const int64_t chunks = (row_groups + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    if (chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
    gather_dequant_kernel<Out>
        <<<dim3(static_cast<unsigned>(n_out), static_cast<unsigned>(chunks)), kThreads, 0,
           stream>>>(static_cast<const typename G::In*>(values), sc, idx,
                     static_cast<uint4*>(out), static_cast<int>(row_groups),
                     static_cast<int>(d / G::kValues), static_cast<int>(segs));
  } else {
    const int64_t chunks = (row_len + kThreads - 1) / kThreads;
    if (chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
    gather_dequant_any<Out>
        <<<dim3(static_cast<unsigned>(n_out), static_cast<unsigned>(chunks)), kThreads, 0,
           stream>>>(static_cast<const int8_t*>(values), sc, idx, static_cast<Out*>(out),
                     row_len, d, segs);
  }
  return 0;
}

bool load_index(RowIndex& ri, const void* idx, int64_t n_out) {
  if (n_out > kMaxRows) return false;
  std::memcpy(ri.v, idx, static_cast<size_t>(n_out) * sizeof(int32_t));
  return true;
}

int launched(int err) { return err != 0 ? err : static_cast<int>(cudaGetLastError()); }

}  // namespace

// Copies n_out <= 2048 rows of row_bytes each. idx points to n_out int32 row
// indices in host memory, already range-checked; they are copied into the
// launch. Returns the cudaError_t of the launch (0 on success).
extern "C" int vqa_gather_rows(const void* table, const void* idx, void* out,
                               int64_t n_out, int64_t row_bytes, void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return 0;
  RowIndex ri;
  if (!load_index(ri, idx, n_out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest unit the row size and both base pointers allow
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launched(launch_gather<uint4>(table, ri, out, n_out, row_bytes, s));
  if (align % 8 == 0) return launched(launch_gather<uint2>(table, ri, out, n_out, row_bytes, s));
  if (align % 4 == 0) return launched(launch_gather<uint32_t>(table, ri, out, n_out, row_bytes, s));
  if (align % 2 == 0) return launched(launch_gather<uint16_t>(table, ri, out, n_out, row_bytes, s));
  return launched(launch_gather<uint8_t>(table, ri, out, n_out, row_bytes, s));
}

// out[b, ..., :] = values[idx[b], ..., :] * scales[idx[b], ..., 0] for int8
// values [N, segs, d] (contiguous) and scales [N, segs, 1] of bf16
// (scale_bf16 = 1) or f32; out is of the scales' dtype. n_out <= 2048 host
// int32 indices as for vqa_gather_rows. Returns the cudaError_t of the launch.
extern "C" int vqa_gather_rows_dequant(const void* values, const void* scales, const void* idx,
                                       void* out, int64_t n_out, int64_t segs, int64_t d,
                                       int scale_bf16, void* stream) {
  if (n_out <= 0 || segs <= 0 || d <= 0) return 0;
  RowIndex ri;
  if (!load_index(ri, idx, n_out)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launched(scale_bf16
                      ? launch_dequant<__nv_bfloat16>(values, scales, ri, out, n_out, segs, d, s)
                      : launch_dequant<float>(values, scales, ri, out, n_out, segs, d, s));
}

// Message for a cudaError_t returned by any vqa_* entry point.
extern "C" const char* vqa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
