// K4: fused filter + gather + aggregate over block-skip candidates (sm_90a).
//
// Replaces the TPU kernel pinot_tpu/ops/pallas_scatter.py `_fused_kernel`
// (via `fused_filter_agg`). For each candidate b of B, over the rows
// r < R of zone block cand[b] of every plane (planes are (S * NB, R)):
//   mask[r]  = filter(row r) && r < rows_in[b]
//   ints[b][0] = number of rows in mask
//   per aggregate: ints[b][slot] = int32 SUM of the storage values, or
//   int MIN / MAX seeded with the plan's fill, or flts[b][slot] = float32
//   MIN / MAX seeded with +-inf.
// Padding candidates (rows_in = 0) give count 0 and the fills. Slots no
// aggregate uses keep the zeros the caller allocated.
//
// The filter differs per query template, so it comes in as a small
// postfix program (IN over <= 8 literals, RANGE with inclusive flags,
// AND / OR / NOT, TRUE / FALSE) inside a descriptor passed by value with
// the column pointers and their storage dtypes. One build serves every
// template. Literals live in a small int32 table on the card, already
// shifted into each plane's storage space and clipped to its range +-1 by
// the caller, so every comparison is an integer comparison.
//
// What bounds it on an H100: bytes read, each candidate block's rows that
// hold data once per plane (1 to 4 bytes a row a plane); bs_month_fused's
// 291 data-holding candidates of 4096 rows over a u16, a u8 and an i32
// plane are 8.3 MB, about 0.0025 ms at 3.35 TB/s. The TPU kernel
// scalar-prefetched the candidate ids into its DMA index maps so the
// (B, R) gather buffer never reached HBM; here each warp reads its own
// candidate id and copies the rows straight into shared memory.
//
// Design: a seed kernel writes every candidate's output row (count 0,
// sums 0, the fills); then one warp per work item, a (candidate, 1024-row
// chunk) pair, four warps a block, a persistent grid striding over the
// items, the descriptor copied to shared memory once per block. Items of
// padding candidates and past a partial block's rows cost one read of
// rows_in. A warp copies each plane's chunk into its shared staging tile
// with 16-byte cp.async copies (only the 16-byte granules that hold data,
// so a partial block reads no more than it holds), then each lane takes
// 32 rows of the chunk (rows k * 32 + lane, so lanes read neighbouring
// shared words) and runs the program ONCE for them: IN and RANGE load the
// 32 values from the staged copy and produce a 32-bit row mask, AND / OR /
// NOT are word operations on a stack of masks. The stack lives in shared
// memory, one word per lane and level ([level][lane], no bank conflicts),
// as deep as the program needs (at most FUSED_MAX_STACK = 32). The
// aggregates read the same staged values under the final mask, reduce
// across the warp with shuffles (no block barrier), and lane 0 merges the
// chunk's partials into the candidate's row with global atomics: a
// candidate's four chunks run on four warps at once, so a month's 291
// candidates keep 1,164 warps busy, not 291. Integer sums are exact in
// any order (the plan keeps every 4096-row partial inside int32, and an
// int32 atomicAdd wraps as the sum does); MIN/MAX merge on K2's int32
// order keys (floats by compare-and-swap on the keys of their bits), so
// the result is bit-identical to the plain version (-0.0 < +0.0). A NaN
// of either sign takes the key that wins its aggregate's op (INT32_MIN
// for MIN, INT32_MAX for MAX, the NaNs 0xffffffff and 0x7fffffff), so it
// propagates as the TPU kernel's vm.min() / vm.max() do, whatever bits it
// was made with (ops/agg.py float_keys is the same rule).
//
// The member-axis entry (`fused_filter_agg_members`) runs M queries of one
// template at once, the cohort of coalesced launches: grid y is the
// member. The planes and the program are shared; member m has its own
// candidates and rows (cand / rows_in + m * B), its own literal table
// (lits + m * lit_mstride) and its own (B, k) outputs. A member's warps do
// exactly what the solo entry's warps do, so M = 1 is the solo entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;  // rows a warp stages at a time: 32 per lane
constexpr int kMaxCols = 8;
constexpr int kMaxProg = 32;
constexpr int kMaxAggs = 8;
constexpr int kMaxLits = 64;

enum Op { OP_TRUE, OP_FALSE, OP_AND, OP_OR, OP_NOT, OP_IN, OP_RANGE };
enum RangeFlag { HAS_LO = 1, HAS_HI = 2, LO_INC = 4, HI_INC = 8 };
enum AggOp { AGG_SUM, AGG_MIN, AGG_MAX };
enum Dtype { U8, U16, I8, I16, I32, F32 };

struct Instr {
  int32_t op, col, a, b, flags;  // IN: a = first literal, b = count;
};                               // RANGE: a = lo literal, b = hi literal

struct Agg {
  int32_t op, col, is_float, slot, fill;  // fill as an order key
};

// the layout ops/kernels.py's _FusedDesc mirrors field for field
struct FusedDesc {
  const void* cols[kMaxCols];
  int32_t dtypes[kMaxCols];
  const int32_t* lits;
  int32_t n_cols, n_prog, n_aggs, n_lits, ki, kf;
  Instr prog[kMaxProg];
  Agg aggs[kMaxAggs];
};

__host__ __device__ __forceinline__ int elem_size(int dtype) {
  return dtype == U8 || dtype == I8 ? 1 : dtype == U16 || dtype == I16 ? 2
                                                                      : 4;
}

__device__ __forceinline__ int32_t order_key(int32_t b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}

// a float's key for a MIN / MAX aggregate: a NaN the extreme that wins it
__device__ __forceinline__ int32_t float_key(int32_t b, int op) {
  if ((b & 0x7fffffff) > 0x7f800000) return op == AGG_MIN ? INT32_MIN
                                                          : INT32_MAX;
  return order_key(b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// the 32 staged values of one lane (rows k * 32 + lane of the chunk),
// widened to int32; float32 planes give their bits
__device__ __forceinline__ void lane_values(const unsigned char* col,
                                            int dtype, int lane,
                                            int32_t v[32]) {
  switch (dtype) {
    case U8: {
      const uint8_t* p = col;
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = p[k * 32 + lane];
      return;
    }
    case I8: {
      const int8_t* p = reinterpret_cast<const int8_t*>(col);
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = p[k * 32 + lane];
      return;
    }
    case U16: {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(col);
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = p[k * 32 + lane];
      return;
    }
    case I16: {
      const int16_t* p = reinterpret_cast<const int16_t*>(col);
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = p[k * 32 + lane];
      return;
    }
    default: {
      const int32_t* p = reinterpret_cast<const int32_t*>(col);
#pragma unroll
      for (int k = 0; k < 32; ++k) v[k] = p[k * 32 + lane];
      return;
    }
  }
}

__device__ __forceinline__ int32_t combine(int op, int32_t x, int32_t y) {
  if (op == AGG_SUM)  // wraps like an int32 sum; the plan keeps it exact
    return static_cast<int32_t>(static_cast<uint32_t>(x) +
                                static_cast<uint32_t>(y));
  return op == AGG_MIN ? min(x, y) : max(x, y);
}

// every candidate's output row: count 0, sums 0, the fills
__global__ void fused_kernel_seed(int B, FusedDesc d,
                                  int32_t* __restrict__ out_i,
                                  float* __restrict__ out_f) {
  const int64_t m = blockIdx.y;  // the member (0 on the solo entry)
  out_i += m * B * d.ki;
  if (out_f != nullptr) out_f += m * B * d.kf;
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    out_i[static_cast<int64_t>(b) * d.ki] = 0;
#pragma unroll
    for (int k = 0; k < kMaxAggs; ++k) {
      if (k >= d.n_aggs) break;
      const Agg ag = d.aggs[k];
      if (ag.is_float)
        out_f[static_cast<int64_t>(b) * d.kf + ag.slot] =
            __int_as_float(order_key(ag.fill));
      else
        out_i[static_cast<int64_t>(b) * d.ki + ag.slot] =
            ag.op == AGG_SUM ? 0 : ag.fill;
    }
  }
}

// a float MIN / MAX partial into its output, on the order keys
__device__ __forceinline__ void float_extreme(float* out, int op,
                                              int32_t key) {
  int* p = reinterpret_cast<int*>(out);
  int old = *reinterpret_cast<volatile int*>(p);
  while (true) {
    const int32_t cur = float_key(old, op);
    if (op == AGG_MIN ? key >= cur : key <= cur) return;
    const int prev = atomicCAS(p, old, order_key(key));
    if (prev == old) return;
    old = prev;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_kernel(const int32_t* __restrict__ cand,
             const int32_t* __restrict__ rows_in, int B, int R, int depth,
             int row_bytes, FusedDesc d, int64_t lit_mstride,
             int32_t* __restrict__ out_i, float* __restrict__ out_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Instr s_prog[kMaxProg];
  __shared__ Agg s_aggs[kMaxAggs];
  __shared__ const unsigned char* s_cols[kMaxCols];
  __shared__ int32_t s_dtypes[kMaxCols];
  __shared__ int32_t s_coloff[kMaxCols];  // staging offset, in chunks
  __shared__ int32_t s_lits[kMaxLits];

  // the descriptor's arrays are read at run-time indexes below: copy them
  // to shared memory with constant indexes only, so the parameter block
  // is never spilled to local memory
  const int t = threadIdx.x;
  const int64_t m = blockIdx.y;  // the member (0 on the solo entry)
  cand += m * B;
  rows_in += m * B;
  out_i += m * B * d.ki;
  if (out_f != nullptr) out_f += m * B * d.kf;
  const int32_t* lits = d.lits + m * lit_mstride;
#pragma unroll
  for (int i = 0; i < kMaxProg; ++i)
    if (t == i) s_prog[i] = d.prog[i];
#pragma unroll
  for (int i = 0; i < kMaxAggs; ++i)
    if (t == kMaxProg + i) s_aggs[i] = d.aggs[i];
  if (t == kMaxProg + kMaxAggs) {
    int off = 0;
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      s_cols[i] = static_cast<const unsigned char*>(d.cols[i]);
      s_dtypes[i] = d.dtypes[i];
      s_coloff[i] = off;
      if (i < d.n_cols) off += elem_size(d.dtypes[i]);
    }
  }
  for (int i = t; i < d.n_lits; i += kThreads) s_lits[i] = lits[i];
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  unsigned char* stage = smem + static_cast<size_t>(warp) * kChunk * row_bytes;
  uint32_t* stack = reinterpret_cast<uint32_t*>(
                        smem + static_cast<size_t>(kWarps) * kChunk *
                                   row_bytes) +
                    warp * depth * 32 + lane;  // stack[level * 32]
  const int n_cols = d.n_cols, n_prog = d.n_prog, n_aggs = d.n_aggs;
  const int chunks = R / kChunk;

  // one work item per (candidate, chunk), the chunks of a candidate on
  // neighbouring warps
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       item < static_cast<int64_t>(B) * chunks;
       item += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int b = static_cast<int>(item / chunks);
    const int c0 = static_cast<int>(item % chunks) * kChunk;
    const int n = rows_in[b];
    if (c0 >= n) continue;  // a padding candidate, or past a partial block
    const int rows = min(kChunk, n - c0);
    const int64_t base = static_cast<int64_t>(cand[b]) * R + c0;

    // the chunk of every plane into shared memory: only the 16-byte
    // granules that hold data, so a partial block reads no more
    __syncwarp();  // every lane is done with the previous item's chunk
    for (int j = 0; j < n_cols; ++j) {
      const int es = elem_size(s_dtypes[j]);
      const int bytes = (rows * es + 15) & ~15;
      const unsigned char* src = s_cols[j] + base * es;
      unsigned char* dst = stage + s_coloff[j] * kChunk;
      for (int o = lane * 16; o < bytes; o += 32 * 16)
        cp_async16(dst + o, src + o);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();

    uint32_t valid = ~0u;
    if (rows < kChunk) {
      valid = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        valid |= static_cast<uint32_t>(k * 32 + lane < rows) << k;
    }

    // the program, once for this lane's 32 rows
    int sp = 0;
    for (int i = 0; i < n_prog; ++i) {
      const Instr ins = s_prog[i];
      uint32_t m;
      switch (ins.op) {
        case OP_TRUE: m = ~0u; break;
        case OP_FALSE: m = 0u; break;
        case OP_AND: {
          const uint32_t y = stack[--sp * 32];
          m = stack[--sp * 32] & y;
          break;
        }
        case OP_OR: {
          const uint32_t y = stack[--sp * 32];
          m = stack[--sp * 32] | y;
          break;
        }
        case OP_NOT: m = ~stack[--sp * 32]; break;
        case OP_IN: {
          int32_t v[32];
          lane_values(stage + s_coloff[ins.col] * kChunk, s_dtypes[ins.col],
                      lane, v);
          m = 0u;
          for (int q = 0; q < ins.b; ++q) {
            const int32_t lit = s_lits[ins.a + q];
#pragma unroll
            for (int k = 0; k < 32; ++k)
              m |= static_cast<uint32_t>(v[k] == lit) << k;
          }
          break;
        }
        default: {  // OP_RANGE, as [lo, hi] in int64 so no bound wraps
          int32_t v[32];
          lane_values(stage + s_coloff[ins.col] * kChunk, s_dtypes[ins.col],
                      lane, v);
          const int64_t lo =
              (ins.flags & HAS_LO)
                  ? static_cast<int64_t>(s_lits[ins.a]) +
                        ((ins.flags & LO_INC) ? 0 : 1)
                  : INT64_MIN;
          const int64_t hi =
              (ins.flags & HAS_HI)
                  ? static_cast<int64_t>(s_lits[ins.b]) -
                        ((ins.flags & HI_INC) ? 0 : 1)
                  : INT64_MAX;
          m = 0u;
#pragma unroll
          for (int k = 0; k < 32; ++k)
            m |= static_cast<uint32_t>(v[k] >= lo && v[k] <= hi) << k;
          break;
        }
      }
      stack[sp++ * 32] = m;
    }
    const uint32_t mask = (n_prog ? stack[0] : ~0u) & valid;

    // count and aggregates over the mask, reduced across the warp; lane 0
    // merges the chunk's partials into the candidate's row
    int32_t cnt = __popc(mask);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (lane == 0 && cnt)
      atomicAdd(&out_i[static_cast<int64_t>(b) * d.ki], cnt);
#pragma unroll
    for (int a = 0; a < kMaxAggs; ++a) {
      if (a >= n_aggs) break;
      const Agg ag = s_aggs[a];
      int32_t v[32];
      lane_values(stage + s_coloff[ag.col] * kChunk, s_dtypes[ag.col], lane,
                  v);
      int32_t x = ag.op == AGG_SUM ? 0 : ag.fill;
      if (ag.op == AGG_SUM) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          x = combine(AGG_SUM, x, ((mask >> k) & 1u) ? v[k] : 0);
      } else if (ag.is_float) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if ((mask >> k) & 1u) x = combine(ag.op, x, float_key(v[k], ag.op));
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          if ((mask >> k) & 1u) x = combine(ag.op, x, v[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = combine(ag.op, x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane != 0) continue;
      if (ag.is_float) {
        if (x != ag.fill)
          float_extreme(&out_f[static_cast<int64_t>(b) * d.kf + ag.slot],
                        ag.op, x);
        continue;
      }
      int32_t* out = &out_i[static_cast<int64_t>(b) * d.ki + ag.slot];
      if (ag.op == AGG_SUM) {
        if (x) atomicAdd(out, x);
      } else if (x != ag.fill) {
        if (ag.op == AGG_MIN) atomicMin(out, x);
        else atomicMax(out, x);
      }
    }
  }
}

}  // namespace

namespace {

// M members of B candidates each (see the entries below)
int launch_fused(const void* cand, const void* rows_in, int B, int M, int R,
                 const void* desc, int64_t lit_mstride, void* out_i,
                 void* out_f, void* stream) {
  const FusedDesc d = *static_cast<const FusedDesc*>(desc);
  if (R % kChunk != 0 || d.n_cols > kMaxCols || d.n_prog > kMaxProg ||
      d.n_aggs > kMaxAggs || d.n_lits > kMaxLits)
    return static_cast<int>(cudaErrorInvalidValue);
  int row_bytes = 0;
  for (int j = 0; j < d.n_cols; ++j) row_bytes += elem_size(d.dtypes[j]);
  int depth = 1, sp = 0;  // the program's deepest stack
  for (int i = 0; i < d.n_prog; ++i) {
    const int op = d.prog[i].op;
    sp += op == OP_AND || op == OP_OR ? -1 : op == OP_NOT ? 0 : 1;
    depth = sp > depth ? sp : depth;
  }
  const size_t smem = static_cast<size_t>(kWarps) *
                      (static_cast<size_t>(kChunk) * row_bytes + 128 * depth);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || M == 0) return static_cast<int>(cudaSuccess);
  const dim3 seed_grid(static_cast<unsigned>((B + 255) / 256),
                       static_cast<unsigned>(M));
  fused_kernel_seed<<<seed_grid, 256, 0, st>>>(
      B, d, static_cast<int32_t*>(out_i), static_cast<float*>(out_f));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, fused_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t items = static_cast<int64_t>(B) * (R / kChunk);
  int64_t blocks = (items + kWarps - 1) / kWarps;
  // the persistent grid's blocks, shared out among the members
  int64_t cap = static_cast<int64_t>(sms) * occ / M;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(M));
  fused_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(rows_in),
      B, R, depth, row_bytes, d, lit_mstride, static_cast<int32_t*>(out_i),
      static_cast<float*>(out_f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand, rows_in (B,) int32 on the card; R rows per block (a multiple of
// 1024); desc a host pointer to the descriptor, copied into the launch by
// value; out_i (B, ki) int32 and out_f (B, kf) float32 (null when
// kf == 0), zeroed by the caller. Every plane must start on 16 bytes.
// Returns the first CUDA error.
extern "C" int fused_filter_agg(const void* cand, const void* rows_in, int B,
                                int R, const void* desc, void* out_i,
                                void* out_f, void* stream) {
  return launch_fused(cand, rows_in, B, 1, R, desc, 0, out_i, out_f, stream);
}

// The member-axis entry: cand, rows_in (M, B) int32; the descriptor's
// literal table holds member m's literals at lits + m * lit_mstride;
// out_i (M, B, ki) int32 and out_f (M, B, kf) float32 (null when kf == 0),
// zeroed by the caller.
extern "C" int fused_filter_agg_members(const void* cand, const void* rows_in,
                                        int B, int M, int R, const void* desc,
                                        int64_t lit_mstride, void* out_i,
                                        void* out_f, void* stream) {
  return launch_fused(cand, rows_in, B, M, R, desc, lit_mstride, out_i, out_f,
                      stream);
}
