// K1: dense per-group sums of bf16 plane channels (sm_90a).
//
// Replaces the TPU kernels pinot_tpu/ops/groupby_mm.py `_kernel` (via
// `group_sums`) and pinot_tpu/ops/pallas_scatter.py `_sums_kernel` (via
// `plane_group_sums`). Both compute one function:
//   out[a, g] = sum over rows r with gid[r] == g of channels[a, r]
// for g in [0, G); rows carrying the overflow id G (masked / padding) or
// any other id outside [0, G) add nothing. Channels are bf16 planes: the
// byte planes of offset integers (|v| <= 255) or the exact 3-way split of
// f32 values (pinot_tpu_torch/ops/groupby_mm.py builds both).
//
// What bounds it on an H100: bytes read. Each row reads a 4-byte id and
// 2 bytes per channel read (an all-ones count channel is not read), so at
// 3.35 TB/s the q1 shape (100M rows, 4 channels, count folded) needs
// about 0.3 ms. The one-hot matmul the TPU used to turn a scatter into
// MXU work has no purpose here: the card has fast shared-memory atomics.
//
// Design: the grid is (row chunks, group partitions). A block owns one
// chunk of at most 65536 rows and one group-range partition whose
// accumulators fit in shared memory; it accumulates the partition's
// channels there in f32, then flushes its non-zero cells into the f64
// output with atomicAdd(double). Integer planes stay exact: a chunk adds
// at most 65536 * 255 < 2^24 per cell (the reference's own argument,
// groupby_mm.py superblocks), and f64 adds of integers below 2^53 are
// exact in any order. Float planes round in f32 per chunk and then add in
// an order that changes between runs, so their sums may differ in the
// last bits from run to run (tests hold them to rtol 1e-6). More than one
// partition re-reads the chunk once per partition: partitions trade
// bandwidth for unbounded group counts, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunkRows = 65536;

__global__ void __launch_bounds__(kThreads)
plane_sums_kernel(const int32_t* __restrict__ gid,
                  const __nv_bfloat16* __restrict__ ch, int64_t n, int A,
                  int G, int first_ones, int span,
                  double* __restrict__ out) {
  extern __shared__ float acc[];  // [A][width]
  const int p0 = blockIdx.y * span;
  const int width = min(span, G - p0);
  const int cells = A * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kChunkRows;
  const int64_t r1 = min(n, r0 + kChunkRows);
  const int a0 = first_ones ? 1 : 0;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int rel = gid[r] - p0;
    if (static_cast<unsigned>(rel) >= static_cast<unsigned>(width)) continue;
    if (first_ones) atomicAdd(&acc[rel], 1.f);
    for (int a = a0; a < A; ++a) {
      const float v = __bfloat162float(ch[static_cast<int64_t>(a) * n + r]);
      if (v != 0.f) atomicAdd(&acc[a * width + rel], v);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) {
      const int a = i / width;
      const int g = i - a * width;
      atomicAdd(&out[static_cast<int64_t>(a) * G + p0 + g],
                static_cast<double>(v));
    }
  }
}

}  // namespace

// gid (n,) int32; ch (A, n) bf16 row-major; out (A, G) f64 zero-filled by
// the caller. span: groups per partition (A * span * 4 bytes of shared
// memory). Returns cudaGetLastError() after the launch.
extern "C" int group_plane_sums(const void* gid, const void* ch, int64_t n,
                                int A, int G, int first_ones, int span,
                                void* out, void* stream) {
  const int width = span < G ? span : G;
  const size_t smem = static_cast<size_t>(A) * width * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      plane_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kChunkRows - 1) / kChunkRows),
                  static_cast<unsigned>((G + span - 1) / span));
  plane_sums_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gid),
      static_cast<const __nv_bfloat16*>(ch), n, A, G, first_ones, span,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
