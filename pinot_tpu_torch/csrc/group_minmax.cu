// K2: per-group MIN and/or MAX of up to 8 value sources in one pass over
// the group ids, each source read as stored (sm_90a).
//
// Replaces the TPU kernel pinot_tpu/ops/pallas_scatter.py `_minmax_kernel`
// (via `group_minmax`):
//   out[s, op][g] = op(fill, op over rows r with gid[r] == g of decode_s(r))
// for g in [0, G); rows whose id lies outside [0, G) (the overflow id G
// carries masked and padding rows) add nothing, and an empty group keeps
// the source's fill. decode_s widens source s's stored value (u8, u16,
// i8, i16, i32 or f32 bits) to int32 and adds its frame-of-reference
// offset, which the kernel reads from the card itself (a 0-d tensor; no
// query syncs on it); the fill is not offset. The TPU kernel took one
// int32/f32 operand per call, widened and decoded by XLA beforehand; here
// every MIN / MAX / MINMAXRANGE of a query shares one launch, and two
// aggregates of one column share one source.
//
// What bounds it on an H100: bytes read, the 4-byte id and each source's
// stored bytes once per row (q6: 4 + 4 + 1 bytes a row, 100M rows: about
// 0.27 ms at 3.35 TB/s).
//
// Design: a persistent grid, a few 256-thread blocks per SM (times the
// group-range partitions when one copy of the accumulators does not fit
// the shared-memory budget). A block owns one contiguous range of rows and
// walks it 16 rows a thread at a time: four 16-byte loads of ids, and per
// source one 16-byte load of u8 / i8, two of u16 / i16 or four of i32 /
// f32, all issued before the values are used. Accumulators are int32 order
// keys in shared memory, one cell per (source, op) and group; when one copy
// is small each warp gets its own, so lanes of different warps do not
// contend. A row touches a cell only when it improves it (read, then
// atomicMin / atomicMax). At the end the copies merge and every cell that
// moved off its fill goes to the output with one global atomic. A seed
// kernel launched first writes the fills into the outputs.
//
// Floats compare as int32 keys under the order-preserving map
// k = b ^ ((b >> 31) & 0x7fffffff) of their bits: -inf < ... < -0.0 < +0.0
// < ... < +inf. A NaN of either sign takes the key that wins its cell's op
// (INT32_MIN in a MIN cell, INT32_MAX in a MAX cell, which decode to the
// NaNs 0xffffffff and 0x7fffffff), so a NaN propagates as in the TPU
// kernel's jnp.minimum / jnp.maximum whatever bits it was made with; the
// fills are never NaN. A float row's key is formed once per cell. Min and
// max are exact and order-free, so the result is bit-identical to the
// plain version, which uses the same keys (ops/agg.py float_keys).
//
// The member-axis entry (`group_minmax_members`) runs M queries of one
// template at once, the cohort of coalesced launches: grid z is the
// member. Member m reads its own group ids (gid + m * gid_mstride),
// writes every cell's output at out + m * out_mstride, and reads a source
// shared by every member (vstride 0) or its own (vstride > 0, a gathered
// block-skip plane; the strides come in a second descriptor,
// MemberStrides). M = 1 is the solo entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSources = 8;
constexpr int kMaxCells = 2 * kMaxSources;
constexpr int kRows = 16;              // rows a thread takes at a time
constexpr int kCopyBytes = 48 * 1024;  // accumulator copies' budget
constexpr int kBlocksPerSM = 4;

enum Dtype { U8, U16, I8, I16, I32, F32 };
enum Op { OP_MIN, OP_MAX };

// the layout ops/kernels.py's _MinMaxSource / _MinMaxDesc mirror
struct Source {
  const void* values;
  const void* plus;   // FOR offset: 0-d tensor of dtype plus_dtype, or null
  int32_t dtype, plus_dtype;
  int32_t cell[2];    // accumulator cell of min / max, -1 when not asked
};

// how each source's values step per member on the member-axis entry (all
// zero on the solo entry): member m's start m * vstride elements on
struct MemberStrides {
  int64_t vstride[kMaxSources];
};

struct MinMaxDesc {
  Source src[kMaxSources];
  int32_t* out[kMaxCells];   // (G,) int32 keys per cell
  int32_t fill[kMaxCells];   // per cell, as an order key
  int32_t op[kMaxCells];     // OP_MIN / OP_MAX per cell
  int32_t n_src, n_cells;
};

__device__ __forceinline__ int32_t order_key(int32_t b) {
  return b ^ ((b >> 31) & 0x7fffffff);
}

// a float's key in a cell of op `op`: a NaN the extreme that wins it
__device__ __forceinline__ int32_t float_key(int32_t b, int op) {
  if ((b & 0x7fffffff) > 0x7f800000) return op == OP_MIN ? INT32_MIN
                                                         : INT32_MAX;
  return order_key(b);
}

// one row's keys into its group's cells (null: the op is not asked),
// each written only where it improves the cell
__device__ __forceinline__ void improve(int32_t* amin, int32_t* amax,
                                        int g, int32_t kmin, int32_t kmax) {
  if (amin != nullptr && kmin < amin[g]) atomicMin(&amin[g], kmin);
  if (amax != nullptr && kmax > amax[g]) atomicMax(&amax[g], kmax);
}

__device__ __forceinline__ int dtype_bytes(int dtype) {
  return dtype == U8 || dtype == I8 ? 1 : dtype == U16 || dtype == I16 ? 2
                                                                      : 4;
}

__device__ __forceinline__ int32_t read_offset(const void* p, int dtype) {
  if (p == nullptr) return 0;
  switch (dtype) {
    case U8: return *static_cast<const uint8_t*>(p);
    case U16: return *static_cast<const uint16_t*>(p);
    case I8: return *static_cast<const int8_t*>(p);
    case I16: return *static_cast<const int16_t*>(p);
    default: return *static_cast<const int32_t*>(p);
  }
}

// the bytes of four words as 16 values, widened with or without sign
template <bool kSigned>
__device__ __forceinline__ void unpack8(const uint4 q, int32_t v[16]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    v[k] = kSigned ? static_cast<int32_t>(static_cast<int8_t>(b))
                   : static_cast<int32_t>(b);
  }
}

template <bool kSigned>
__device__ __forceinline__ void unpack16(const uint4 a, const uint4 c,
                                         int32_t v[16]) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t h = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
    v[k] = kSigned ? static_cast<int32_t>(static_cast<int16_t>(h))
                   : static_cast<int32_t>(h);
  }
}

// 16 stored values from row r widened to int32 (f32 gives its bits);
// cnt < 16 only at the ragged end, read one by one with constant indexes
__device__ __forceinline__ void load16(const void* p, int dtype, int64_t r,
                                       int cnt, int32_t v[16]) {
  if (cnt == kRows) {
    switch (dtype) {
      case U8:
      case I8: {
        const uint4 q = *reinterpret_cast<const uint4*>(
            static_cast<const uint8_t*>(p) + r);
        if (dtype == U8) unpack8<false>(q, v); else unpack8<true>(q, v);
        return;
      }
      case U16:
      case I16: {
        const uint4* q = reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(p) + r);
        const uint4 a = q[0], c = q[1];
        if (dtype == U16) unpack16<false>(a, c, v);
        else unpack16<true>(a, c, v);
        return;
      }
      default: {  // I32, F32
        const int4* q = reinterpret_cast<const int4*>(
            static_cast<const int32_t*>(p) + r);
        const int4 a = q[0], b = q[1], c = q[2], d = q[3];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
        v[12] = d.x; v[13] = d.y; v[14] = d.z; v[15] = d.w;
        return;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j >= cnt) {
      v[j] = 0;
      continue;
    }
    switch (dtype) {
      case U8: v[j] = static_cast<const uint8_t*>(p)[r + j]; break;
      case U16: v[j] = static_cast<const uint16_t*>(p)[r + j]; break;
      case I8: v[j] = static_cast<const int8_t*>(p)[r + j]; break;
      case I16: v[j] = static_cast<const int16_t*>(p)[r + j]; break;
      default: v[j] = static_cast<const int32_t*>(p)[r + j]; break;
    }
  }
}

__global__ void minmax_kernel_seed(MinMaxDesc d, int G, int64_t out_mstride) {
  const int c = blockIdx.y;
  if (c >= d.n_cells) return;
  int32_t* out = nullptr;
  int32_t fill = 0;
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i)
    if (i == c) {
      out = d.out[i];
      fill = d.fill[i];
    }
  out += static_cast<int64_t>(blockIdx.z) * out_mstride;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += gridDim.x * blockDim.x)
    out[g] = fill;
}

__global__ void __launch_bounds__(kThreads)
minmax_kernel(const int32_t* __restrict__ gid, MinMaxDesc d, int64_t n,
              int G, int span, int copies, int64_t rows_per_block,
              MemberStrides ms, int64_t gid_mstride, int64_t out_mstride) {
  extern __shared__ int32_t acc[];  // [copies][n_cells][width]
  __shared__ Source s_src[kMaxSources];
  __shared__ int32_t s_plus[kMaxSources];
  __shared__ int32_t* s_out[kMaxCells];
  __shared__ int32_t s_fill[kMaxCells];
  __shared__ int32_t s_op[kMaxCells];

  // the descriptor's arrays are read at run-time indexes below: copy them
  // to shared memory with constant indexes only, so the parameter block
  // is never spilled to local memory
  const int t = threadIdx.x;
  const int64_t m = blockIdx.z;  // the member (0 on the solo entry)
  gid += m * gid_mstride;
#pragma unroll
  for (int i = 0; i < kMaxSources; ++i)
    if (t == i) {
      Source s = d.src[i];
      if (i < d.n_src)
        s.values = static_cast<const char*>(s.values) +
                   m * ms.vstride[i] * dtype_bytes(s.dtype);
      s_src[i] = s;
      s_plus[i] = i < d.n_src ? read_offset(s.plus, s.plus_dtype) : 0;
    }
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i)
    if (t == kMaxSources + i) {
      s_out[i] = d.out[i] == nullptr ? nullptr : d.out[i] + m * out_mstride;
      s_fill[i] = d.fill[i];
      s_op[i] = d.op[i];
    }
  __syncthreads();
  const int n_src = d.n_src, n_cells = d.n_cells;

  const int p0 = blockIdx.y * span;
  const int width = min(span, G - p0);
  const int cells = n_cells * width;  // per copy
  for (int i = t; i < copies * cells; i += kThreads)
    acc[i] = s_fill[(i % cells) / width];
  __syncthreads();
  int32_t* my = acc + ((t >> 5) % copies) * cells;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t b1 = min(n, b0 + rows_per_block);
  for (int64_t r = b0 + static_cast<int64_t>(kRows) * t; r < b1;
       r += static_cast<int64_t>(kRows) * kThreads) {
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kRows), b1 - r));
    int rel[kRows];
    if (cnt == kRows) {
      const int4* q = reinterpret_cast<const int4*>(gid + r);
      const int4 a = q[0], b = q[1], c = q[2], e = q[3];
      rel[0] = a.x; rel[1] = a.y; rel[2] = a.z; rel[3] = a.w;
      rel[4] = b.x; rel[5] = b.y; rel[6] = b.z; rel[7] = b.w;
      rel[8] = c.x; rel[9] = c.y; rel[10] = c.z; rel[11] = c.w;
      rel[12] = e.x; rel[13] = e.y; rel[14] = e.z; rel[15] = e.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) rel[j] = j < cnt ? gid[r + j] : -1;
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      rel[j] -= p0;
      if (static_cast<unsigned>(rel[j]) >= static_cast<unsigned>(width))
        rel[j] = -1;
      any |= rel[j] >= 0;
    }
    if (!any) continue;
    for (int si = 0; si < n_src; ++si) {
      const Source& s = s_src[si];
      int32_t v[kRows];
      load16(s.values, s.dtype, r, cnt, v);
      const int32_t plus = s_plus[si];
      int32_t* amin = s.cell[OP_MIN] >= 0 ? my + s.cell[OP_MIN] * width
                                          : nullptr;
      int32_t* amax = s.cell[OP_MAX] >= 0 ? my + s.cell[OP_MAX] * width
                                          : nullptr;
      if (s.dtype == F32) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (rel[j] >= 0)
            improve(amin, amax, rel[j], float_key(v[j], OP_MIN),
                    float_key(v[j], OP_MAX));
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (rel[j] >= 0) improve(amin, amax, rel[j], v[j] + plus,
                                   v[j] + plus);
      }
    }
  }
  __syncthreads();

  // merge the copies; flush the cells that moved off their fill
  for (int i = t; i < cells; i += kThreads) {
    const int c = i / width;
    const bool is_min = s_op[c] == OP_MIN;
    int32_t m = acc[i];
    for (int k = 1; k < copies; ++k) {
      const int32_t x = acc[k * cells + i];
      m = is_min ? min(m, x) : max(m, x);
    }
    if (m == s_fill[c]) continue;
    int32_t* out = s_out[c] + p0 + (i - c * width);
    if (is_min) atomicMin(out, m);
    else atomicMax(out, m);
  }
}

}  // namespace

namespace {

// M members of n rows each; member m reads gid + m * gid_mstride and
// writes each cell at out + m * out_mstride (see the entries below)
int launch_minmax(const void* gid, const void* desc, const MemberStrides& ms,
                  int64_t n, int M, int64_t gid_mstride, int G, int span,
                  int smem_budget, int64_t out_mstride, void* stream) {
  const MinMaxDesc& d = *static_cast<const MinMaxDesc*>(desc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 seed_grid(static_cast<unsigned>((G + 255) / 256),
                       static_cast<unsigned>(d.n_cells),
                       static_cast<unsigned>(M));
  minmax_kernel_seed<<<seed_grid, 256, 0, st>>>(d, G, out_mstride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);

  const int width = span < G ? span : G;
  const size_t copy_bytes = static_cast<size_t>(width) * 4 * d.n_cells;
  int copies = static_cast<int>(kCopyBytes / (copy_bytes ? copy_bytes : 1));
  copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  if (copies * copy_bytes > static_cast<size_t>(smem_budget)) copies = 1;
  const size_t smem = copies * copy_bytes;
  err = cudaFuncSetAttribute(minmax_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, minmax_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int parts = (G + span - 1) / span;
  const int per_sm = occ < kBlocksPerSM ? occ : kBlocksPerSM;
  int64_t blocks = (static_cast<int64_t>(sms) * per_sm + parts - 1) / parts;
  const int64_t tiles = (n + kRows - 1) / kRows;
  const int64_t max_blocks = (tiles + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  // whole 16-row tiles per block, so every vector load is aligned
  const int64_t rows_per_block = ((tiles + blocks - 1) / blocks) * kRows;
  blocks = (n + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(parts),
                  static_cast<unsigned>(M));
  minmax_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int32_t*>(gid), d, n, G, span, copies,
      rows_per_block, ms, gid_mstride, out_mstride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gid (n,) int32; desc: a MinMaxDesc in host memory, passed to the kernels
// by value; every output (G,) int32, written by the seed kernel. span:
// groups per partition (one copy of its accumulators fits `smem_budget`
// bytes). Every value pointer must be 16-byte aligned. Returns the first
// CUDA error.
extern "C" int group_minmax(const void* gid, const void* desc, int64_t n,
                            int G, int span, int smem_budget, void* stream) {
  const MemberStrides solo = {};
  return launch_minmax(gid, desc, solo, n, 1, 0, G, span, smem_budget, 0,
                       stream);
}

// The member-axis entry: gid (M, n) int32, member m's ids at
// gid + m * gid_mstride; each cell's output is (M, ...) with member m's
// (G,) keys at out[c] + m * out_mstride; strides: a MemberStrides in host
// memory. Every member's value pointer must be 16-byte aligned.
extern "C" int group_minmax_members(const void* gid, const void* desc,
                                    const void* strides, int64_t n, int M,
                                    int64_t gid_mstride, int G, int span,
                                    int smem_budget, int64_t out_mstride,
                                    void* stream) {
  return launch_minmax(gid, desc, *static_cast<const MemberStrides*>(strides),
                       n, M, gid_mstride, G, span, smem_budget, out_mstride,
                       stream);
}
