// gather_rows: out[b] = table[idx[b]] for a row-major table [N, ...].
//
// Replaces vqa_tpu/ops/gather.py::_gather_rows_pallas (_pallas_fwd, _kernel,
// _make_multi_kernel): the scalar-prefetched row gather of the device-resident
// feature table that the eval step runs (engine/steps.py::_resolve_visual).
//
// What bounds it on the H100: memory traffic only. At the flagship shape
// (B=1024 rows of 36x2048 bf16 = 147,456 bytes each) it reads and writes
// ~151 MB each way and does no arithmetic, so its floor is ~302 MB over the
// card's 3.35 TB/s.
//
// What the design does about it: one block per output row, every thread
// copying the widest unit (16 bytes where the row size and both base pointers
// allow it) with neighbouring threads on neighbouring addresses, so both the
// read of the source row and the write of the output row are fully
// coalesced. The block loads its own index (the TPU kernel prefetched them as
// scalars). The output is a bit-exact copy. Index range is checked by the
// Python wrapper on the host, before the indices are uploaded.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Unit* __restrict__ table, const int64_t* __restrict__ idx,
                   Unit* __restrict__ out, int64_t row_units) {
  const int64_t b = blockIdx.x;
  const Unit* src = table + idx[b] * row_units;
  Unit* dst = out + b * row_units;
  for (int64_t i = threadIdx.x; i < row_units; i += kThreads) dst[i] = src[i];
}

template <typename Unit>
void launch(const void* table, const int64_t* idx, void* out, int64_t n_out,
            int64_t row_bytes, cudaStream_t stream) {
  gather_rows_kernel<Unit><<<static_cast<unsigned>(n_out), kThreads, 0, stream>>>(
      static_cast<const Unit*>(table), idx, static_cast<Unit*>(out),
      row_bytes / static_cast<int64_t>(sizeof(Unit)));
}

}  // namespace

// Copies n_out rows of row_bytes each. idx is int64 on the device. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int vqa_gather_rows(const void* table, const void* idx, void* out,
                               int64_t n_out, int64_t row_bytes, void* stream) {
  if (n_out <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) {
    launch<uint4>(table, ix, out, n_out, row_bytes, s);
  } else if (align % 8 == 0) {
    launch<uint2>(table, ix, out, n_out, row_bytes, s);
  } else if (align % 4 == 0) {
    launch<uint32_t>(table, ix, out, n_out, row_bytes, s);
  } else if (align % 2 == 0) {
    launch<uint16_t>(table, ix, out, n_out, row_bytes, s);
  } else {
    launch<uint8_t>(table, ix, out, n_out, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a cudaError_t returned by any vqa_* entry point.
extern "C" const char* vqa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
