// K3: HyperLogLog register build, the per-slot max of rho (sm_90a).
//
// Replaces two TPU kernels that compute the same function:
//   - pinot_tpu/ops/pallas_scatter.py `_hll_kernel` (via
//     `hll_register_max`): presence of rho == r per slot as f32 counts
//     over slot partitions, register = max r present; <= 4096 slots;
//   - pinot_tpu/ops/groupby_mm.py `_kernel` in rho_mode (via
//     `rho_group_counts` / `hll_registers`): an (nrho, slots) count
//     matrix built with the MXU and reduced at once to the registers;
//     <= 2^20 slots.
// Both are MXU formulations of a scatter-max, which the TPU lacks. Here:
//   reg[s] = max(0, max over rows r with slot[r] == s of rho[r])
// for s in [0, nslots); rows whose slot lies outside [0, nslots) (the
// overflow slot nslots carries masked and padding rows) add nothing, and
// a slot no row reaches stays 0. No count matrix is ever formed.
//
// What bounds it on an H100: bytes read, 8 per row (an int32 slot and an
// int32 rho): 100M rows need about 0.24 ms at 3.35 TB/s, plus 4 bytes per
// slot written.
//
// Design: the grid is (65,536-row chunks, slot partitions). Each block
// zeroes int32 registers for its slot range in shared memory (at most
// `span` slots, 51,200 with 200 KB), folds its chunk in with shared
// atomicMax, and flushes its non-zero cells into the output, zeroed by
// the caller, with global atomicMax. Max is idempotent and order-free,
// so the result is bit-identical to the plain version. One partition
// covers every slot space up to `span`; the largest (2^20 slots) takes
// 21 partitions, each of which re-reads the rows: 21 x 8 bytes a row.
// Byte registers and hashing in the kernel are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int64_t kChunkRows = 65536;

__global__ void __launch_bounds__(kThreads)
hll_kernel(const int32_t* __restrict__ slot, const int32_t* __restrict__ rho,
           int64_t n, int nslots, int span, int32_t* __restrict__ out) {
  extern __shared__ int32_t reg[];  // [width] registers of this partition
  const int p0 = blockIdx.y * span;
  const int width = min(span, nslots - p0);
  for (int i = threadIdx.x; i < width; i += blockDim.x) reg[i] = 0;
  __syncthreads();

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kChunkRows;
  const int64_t r1 = min(n, r0 + kChunkRows);
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int rel = slot[r] - p0;
    if (static_cast<unsigned>(rel) >= static_cast<unsigned>(width)) continue;
    const int32_t v = rho[r];
    if (v > reg[rel]) atomicMax(&reg[rel], v);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    if (reg[i] != 0) atomicMax(&out[p0 + i], reg[i]);
  }
}

}  // namespace

// slot, rho (n,) int32; out (nslots,) int32, zeroed by the caller; span:
// slots per partition (<= the shared memory the caller allows). Returns
// cudaGetLastError() after the launch.
extern "C" int hll_register_max(const void* slot, const void* rho, int64_t n,
                                int nslots, int span, void* out,
                                void* stream) {
  const int width = span < nslots ? span : nslots;
  const size_t smem = static_cast<size_t>(width) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      hll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kChunkRows - 1) / kChunkRows),
                  static_cast<unsigned>((nslots + span - 1) / span));
  hll_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(rho), n,
      nslots, span, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
