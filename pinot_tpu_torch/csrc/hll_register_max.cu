// K3: HyperLogLog register build from the stored hashes (sm_90a).
//
// Replaces two TPU kernels that compute the same function:
//   - pinot_tpu/ops/pallas_scatter.py `_hll_kernel` (via
//     `hll_register_max`): presence of rho == r per slot as f32 counts
//     over slot partitions, register = max r present; <= 4096 slots;
//   - pinot_tpu/ops/groupby_mm.py `_kernel` in rho_mode (via
//     `rho_group_counts` / `hll_registers`): an (nrho, slots) count
//     matrix built with the MXU and reduced at once to the registers;
//     <= 2^20 slots.
// Both are MXU formulations of a scatter-max, which the TPU lacks, fed
// slot and rho operands that the reference's jit fuses out of the hash
// plane. Here the kernel reads the 32-bit hash plane itself and splits
// each hash in registers, bit-identical with ops/hll.py hll_idx_rho:
//   u = (uint32) h;  idx = u >> (32 - log2m)
//   rho = clz((u << log2m) | 1 << (log2m - 1)) + 1   (<= 33 - log2m)
//   slot = gid * 2^log2m + idx
//   reg[slot] = max(0, max rho over the rows that land on slot)
// A row adds nothing when its mask byte is 0 or its group id lies
// outside [0, G) (the overflow id G carries masked and padding rows);
// without group ids every row is group 0, without a mask every row
// counts. No slot or rho tensor and no count matrix is ever formed.
//
// What bounds it on an H100: bytes read, the 4-byte hash plus the 4-byte
// group id or the 1-byte mask per row: 100M rows need 0.15-0.24 ms at
// 3.35 TB/s, plus 4 bytes per slot written.
//
// Design: a persistent grid, one 1024-thread block per SM (times the
// slot partitions past one block's shared memory). A block owns one
// contiguous range of rows, walks it four rows a thread at a time with
// vector loads, and keeps int32 registers for its slot range in shared
// memory: up to 57,344 slots in 224 KB, so the HLL path's slot spaces
// (1024 scalar, 35,840 for d_year x c_region) are one partition and 2^20
// slots take 19. A row raises its register with a shared atomicMax only
// when its rho is larger than the value it reads, which most rows are
// not. At the end each block flushes its non-zero registers into the
// int32 output, zeroed by the caller, with global atomicMax: once per
// block. Max is idempotent and order-free, so the result is
// bit-identical to the plain version. Byte registers would hold four
// times the slots per partition, but a byte has no atomic max: the
// compare-and-swap loop that would stand in for it serializes the lanes
// that raise a register.
//
// The member-axis entry (`hll_register_max_members`) runs M queries of one
// template at once, the cohort of coalesced launches: grid z is the
// member. Member m reads hash + m * hash_mstride (0: the stored plane all
// members share), its own group ids and mask at their member strides, and
// writes its own (G << log2m,) registers. M = 1 is the solo entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBlocksPerSM = 1;

__global__ void __launch_bounds__(kThreads)
hll_kernel(const uint32_t* __restrict__ hash, const int32_t* __restrict__ gid,
           const uint8_t* __restrict__ mask, int64_t n, int log2m, int G,
           int span, int64_t rows_per_block, int64_t hash_mstride,
           int64_t gid_mstride, int64_t mask_mstride,
           int32_t* __restrict__ out) {
  extern __shared__ int32_t reg[];  // this partition's registers
  const int64_t nslots = static_cast<int64_t>(G) << log2m;
  const int64_t m = blockIdx.z;  // the member (0 on the solo entry)
  hash += m * hash_mstride;
  if (gid != nullptr) gid += m * gid_mstride;
  if (mask != nullptr) mask += m * mask_mstride;
  out += m * nslots;
  const int p0 = blockIdx.y * span;
  const int width = static_cast<int>(min(static_cast<int64_t>(span),
                                         nslots - p0));
  for (int i = threadIdx.x; i < width; i += kThreads) reg[i] = 0;
  __syncthreads();

  const int shift = 32 - log2m;
  const uint32_t sentinel = 1u << (log2m - 1);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t b1 = min(n, b0 + rows_per_block);
  for (int64_t r = b0 + 4 * static_cast<int64_t>(threadIdx.x); r < b1;
       r += 4 * kThreads) {
    const int cnt = static_cast<int>(min(static_cast<int64_t>(4), b1 - r));
    uint32_t h[4];
    int g[4] = {0, 0, 0, 0};
    bool keep[4] = {true, true, true, true};
    if (cnt == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(hash + r);
      h[0] = q.x; h[1] = q.y; h[2] = q.z; h[3] = q.w;
      if (gid != nullptr) {
        const int4 gq = *reinterpret_cast<const int4*>(gid + r);
        g[0] = gq.x; g[1] = gq.y; g[2] = gq.z; g[3] = gq.w;
      }
      if (mask != nullptr) {
        const uchar4 mq = *reinterpret_cast<const uchar4*>(mask + r);
        keep[0] = mq.x; keep[1] = mq.y; keep[2] = mq.z; keep[3] = mq.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[j] = j < cnt;
        if (!keep[j]) continue;
        h[j] = hash[r + j];
        if (gid != nullptr) g[j] = gid[r + j];
        if (mask != nullptr) keep[j] = mask[r + j] != 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!keep[j] || static_cast<unsigned>(g[j]) >= static_cast<unsigned>(G))
        continue;
      const uint32_t u = h[j];
      const int64_t slot = (static_cast<int64_t>(g[j]) << log2m) + (u >> shift);
      const int64_t rel = slot - p0;
      if (rel < 0 || rel >= width) continue;
      const int rho = __clz((u << log2m) | sentinel) + 1;
      if (rho > reg[rel]) atomicMax(&reg[rel], rho);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < width; i += kThreads)
    if (reg[i] != 0) atomicMax(&out[p0 + i], reg[i]);
}

}  // namespace

namespace {

// M members of n rows each (see the entries below)
int launch_hll(const void* hash, const void* gid, const void* mask, int64_t n,
               int M, int64_t hash_mstride, int64_t gid_mstride,
               int64_t mask_mstride, int log2m, int G, int span, void* out,
               void* stream) {
  const int64_t nslots = static_cast<int64_t>(G) << log2m;
  const int width = span < nslots ? span : static_cast<int>(nslots);
  const size_t smem = static_cast<size_t>(width) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      hll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, hll_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int parts = static_cast<int>((nslots + span - 1) / span);
  const int per_sm = occ < kBlocksPerSM ? occ : kBlocksPerSM;
  int64_t blocks = (static_cast<int64_t>(sms) * per_sm + parts - 1) / parts;
  const int64_t quads = (n + 3) / 4;
  const int64_t max_blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  // whole quads per block, so every vector load is aligned
  const int64_t rows_per_block = ((quads + blocks - 1) / blocks) * 4;
  blocks = (n + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(parts),
                  static_cast<unsigned>(M));
  hll_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hash), static_cast<const int32_t*>(gid),
      static_cast<const uint8_t*>(mask), n, log2m, G, span, rows_per_block,
      hash_mstride, gid_mstride, mask_mstride, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hash (n,) uint32 bits; gid (n,) int32 or null; mask (n,) bool bytes or
// null; out (G << log2m,) int32, zeroed by the caller; span: slots per
// partition (4 * span bytes of shared memory). Every pointer must be
// 16-byte aligned. Returns the first CUDA error.
extern "C" int hll_register_max(const void* hash, const void* gid,
                                const void* mask, int64_t n, int log2m, int G,
                                int span, void* out, void* stream) {
  return launch_hll(hash, gid, mask, n, 1, 0, 0, 0, log2m, G, span, out,
                    stream);
}

// The member-axis entry: member m's hashes, ids and mask at their member
// strides (elements; 0 shares one plane among the members), its registers
// at out + m * (G << log2m); out (M, G << log2m) int32 zeroed by the caller.
// Every member's pointers must be 16-byte aligned.
extern "C" int hll_register_max_members(const void* hash, const void* gid,
                                        const void* mask, int64_t n, int M,
                                        int64_t hash_mstride,
                                        int64_t gid_mstride,
                                        int64_t mask_mstride, int log2m,
                                        int G, int span, void* out,
                                        void* stream) {
  return launch_hll(hash, gid, mask, n, M, hash_mstride, gid_mstride,
                    mask_mstride, log2m, G, span, out, stream);
}
