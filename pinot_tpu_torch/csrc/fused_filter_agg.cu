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
// AND / OR / NOT, TRUE / FALSE) run per row on a one-word bit stack,
// inside a descriptor passed by value with the column pointers and their
// storage dtypes. One build serves every template. Literals live in a
// small int32 table on the card, already shifted into each plane's
// storage space and clipped to its range +-1 by the caller, so every
// comparison is an int32 comparison.
//
// What bounds it on an H100: bytes read, each candidate block's rows of
// each plane once (1 to 4 bytes a row a plane); B = 1,526 candidates of
// 4096 rows over three u16 planes are 37.5 MB, about 0.011 ms at
// 3.35 TB/s. The TPU kernel scalar-prefetched the candidate ids into its
// DMA index maps so the (B, R) gather buffer never reached HBM; here
// each block reads its own candidate id and loads the rows directly.
//
// Design, simple first: one 256-thread block per candidate, each thread
// striding over the block's rows; the program, the aggregates' specs and
// the literals copied to shared memory at block start; per-thread
// accumulators, a warp-shuffle reduction, then one across the 8 warps in
// shared memory. Integer sums are exact in any order (the plan keeps
// every 4096-row partial inside int32); float MIN/MAX reduce on K2's
// int32 order keys, so the result is bit-identical to the plain version
// (-0.0 < +0.0; a positive NaN wins MAX and loses MIN).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ int32_t order_key(int32_t b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}

// storage value widened to int32; float32 planes give their bits
__device__ __forceinline__ int32_t load_value(const void* p, int dtype,
                                              int64_t i) {
  switch (dtype) {
    case U8: return static_cast<const uint8_t*>(p)[i];
    case U16: return static_cast<const uint16_t*>(p)[i];
    case I8: return static_cast<const int8_t*>(p)[i];
    case I16: return static_cast<const int16_t*>(p)[i];
    default: return static_cast<const int32_t*>(p)[i];
  }
}

__device__ __forceinline__ int32_t combine(int op, int32_t x, int32_t y) {
  if (op == AGG_SUM)  // wraps like an int32 sum; the plan keeps it exact
    return static_cast<int32_t>(static_cast<uint32_t>(x) +
                                static_cast<uint32_t>(y));
  return op == AGG_MIN ? min(x, y) : max(x, y);
}

__global__ void __launch_bounds__(kThreads)
fused_kernel(const int32_t* __restrict__ cand,
             const int32_t* __restrict__ rows_in, int R, FusedDesc d,
             int32_t* __restrict__ out_i, float* __restrict__ out_f) {
  __shared__ Instr s_prog[kMaxProg];
  __shared__ Agg s_aggs[kMaxAggs];
  __shared__ const void* s_cols[kMaxCols];
  __shared__ int32_t s_dtypes[kMaxCols];
  __shared__ int32_t s_lits[kMaxLits];
  __shared__ int32_t s_red[kWarps][1 + kMaxAggs];

  // the descriptor's arrays are read at run-time indexes below: copy
  // them to shared memory with constant indexes only, so the parameter
  // block is never spilled to local memory
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kMaxProg; ++i)
    if (t == i) s_prog[i] = d.prog[i];
#pragma unroll
  for (int i = 0; i < kMaxAggs; ++i)
    if (t == kMaxProg + i) s_aggs[i] = d.aggs[i];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i)
    if (t == kMaxProg + kMaxAggs + i) {
      s_cols[i] = d.cols[i];
      s_dtypes[i] = d.dtypes[i];
    }
  for (int i = t; i < d.n_lits; i += kThreads) s_lits[i] = d.lits[i];
  __syncthreads();

  const int b = blockIdx.x;
  const int n = rows_in[b];
  const int64_t base = static_cast<int64_t>(cand[b]) * R;
  const int n_prog = d.n_prog;
  const int n_aggs = d.n_aggs;

  int32_t acc[1 + kMaxAggs];
  acc[0] = 0;
#pragma unroll
  for (int k = 0; k < kMaxAggs; ++k)
    acc[1 + k] = (k < n_aggs && s_aggs[k].op != AGG_SUM) ? s_aggs[k].fill
                                                         : 0;

  for (int r = t; r < n; r += kThreads) {
    const int64_t row = base + r;
    uint32_t st = 0;  // bit stack, top of stack in bit 0
    for (int i = 0; i < n_prog; ++i) {
      const Instr ins = s_prog[i];
      uint32_t bit;
      switch (ins.op) {
        case OP_TRUE: st = (st << 1) | 1u; continue;
        case OP_FALSE: st <<= 1; continue;
        case OP_AND: bit = st & (st >> 1) & 1u; st = ((st >> 2) << 1) | bit;
          continue;
        case OP_OR: bit = (st | (st >> 1)) & 1u; st = ((st >> 2) << 1) | bit;
          continue;
        case OP_NOT: st ^= 1u; continue;
        case OP_IN: {
          const int32_t v = load_value(s_cols[ins.col], s_dtypes[ins.col], row);
          bit = 0;
          for (int k = 0; k < ins.b; ++k) bit |= (v == s_lits[ins.a + k]);
          break;
        }
        default: {  // OP_RANGE
          const int32_t v = load_value(s_cols[ins.col], s_dtypes[ins.col], row);
          bool m = true;
          if (ins.flags & HAS_LO) {
            const int32_t lo = s_lits[ins.a];
            m = m && ((ins.flags & LO_INC) ? v >= lo : v > lo);
          }
          if (ins.flags & HAS_HI) {
            const int32_t hi = s_lits[ins.b];
            m = m && ((ins.flags & HI_INC) ? v <= hi : v < hi);
          }
          bit = m;
          break;
        }
      }
      st = (st << 1) | bit;
    }
    if (!(st & 1u)) continue;
    acc[0] += 1;
#pragma unroll
    for (int k = 0; k < kMaxAggs; ++k) {
      if (k >= n_aggs) break;
      const Agg ag = s_aggs[k];
      int32_t v = load_value(s_cols[ag.col], s_dtypes[ag.col], row);
      if (ag.is_float) v = order_key(v);
      acc[1 + k] = combine(ag.op, acc[1 + k], v);
    }
  }

  // reduce: warp shuffles, then across the warps in shared memory
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int k = 0; k <= kMaxAggs; ++k) {
    if (k > n_aggs) break;
    const int op = k == 0 ? AGG_SUM : s_aggs[k - 1].op;
    int32_t v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = combine(op, v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) s_red[warp][k] = v;
  }
  __syncthreads();
  if (t > n_aggs) return;
  const int op = t == 0 ? AGG_SUM : s_aggs[t - 1].op;
  int32_t v = s_red[0][t];
  for (int w = 1; w < kWarps; ++w) v = combine(op, v, s_red[w][t]);
  if (t == 0) {
    out_i[static_cast<int64_t>(b) * d.ki] = v;
    return;
  }
  const Agg ag = s_aggs[t - 1];
  if (ag.is_float)
    out_f[static_cast<int64_t>(b) * d.kf + ag.slot] =
        __int_as_float(order_key(v));
  else
    out_i[static_cast<int64_t>(b) * d.ki + ag.slot] = v;
}

}  // namespace

// cand, rows_in (B,) int32 on the card; R rows per block; desc a host
// pointer to the descriptor, copied into the launch by value; out_i
// (B, ki) int32 and out_f (B, kf) float32 (null when kf == 0), zeroed by
// the caller. Returns cudaGetLastError() after the launch.
extern "C" int fused_filter_agg(const void* cand, const void* rows_in, int B,
                                int R, const void* desc, void* out_i,
                                void* out_f, void* stream) {
  const FusedDesc d = *static_cast<const FusedDesc*>(desc);
  fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(rows_in),
      R, d, static_cast<int32_t*>(out_i), static_cast<float*>(out_f));
  return static_cast<int>(cudaGetLastError());
}
