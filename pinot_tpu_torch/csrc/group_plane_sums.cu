// K1: dense per-group sums of value planes, split in registers (sm_90a).
//
// Replaces the TPU kernels pinot_tpu/ops/groupby_mm.py `_kernel` (via
// `group_sums`) and pinot_tpu/ops/pallas_scatter.py `_sums_kernel` (via
// `plane_group_sums`). Both compute one function over bf16 channels:
//   out[a, g] = sum over rows r with gid[r] == g of channel a at row r
// for g in [0, G); rows carrying the overflow id G (masked / padding) or
// any other id outside [0, G) add nothing. The reference builds its
// channels in HBM before the kernel (jit fuses that pass into the
// operands); here the kernel reads the values as they are stored and
// builds the channels in registers, one source at a time:
//   - an integer source (u8, u16, u32, i8, i16, i32, i64 plane) adds
//     its FOR offset and subtracts the query's offset in int64, then
//     splits into `nplanes` byte planes (v >> 8k) & 0xFF, the reference's
//     int_planes;
//   - a float source (f32) splits exactly into three bf16 planes by bit
//     masking (m0 = hi16(v), m1 = hi16(v - m0), m2 = hi16(v - m0 - m1)),
//     the reference's float_planes;
//   - a bf16 source is one channel as it is (the sorted HLL build's
//     power-of-two channels);
//   - the count channel, when asked for, is output row 0 and reads
//     nothing.
// Output rows follow that order: count, then each source's planes.
//
// What bounds it on an H100: bytes read, the 4-byte id and each source's
// stored bytes once per row; q1 (100M rows, an i32 revenue plane) needs
// 8 bytes a row, about 0.24 ms at 3.35 TB/s.
//
// Design: a persistent grid, one 1024-thread block per SM (times the
// group-range partitions when the accumulators of every group do not fit
// one block's shared memory). A block owns one contiguous range of rows
// and walks it four rows a thread at a time with vector loads. Byte
// planes and the count accumulate in int32 shared cells: a cell gains at
// most 255 a row, so a block flushes after at most floor((2^31 - 1) /
// 255) = 8,421,504 rows (`seg_rows`, from the caller) and, at 100M rows
// over 132 blocks, flushes exactly once. Float planes and bf16 channels
// accumulate in f64 shared cells (no flush bound; the sorted HLL's
// channels are integers below 2^15 whose sums stay below 2^53, so they
// are exact in any order). When one copy of the accumulators is small
// (few groups), each warp gets its own copy, up to 48 KB, so the lanes
// of different warps do not contend for the same cells; the copies merge
// at the flush. The flush adds each non-zero cell into the f64 output
// (zero-filled by the caller) with atomicAdd(double): integer sums below
// 2^53 are exact in any order; float sums may differ from run to run in
// the last bits (tests hold them to rtol 1e-6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSources = 15;
constexpr int kMaxRows = 16;          // output rows: count + 15 channels
constexpr int kCopyBytes = 48 * 1024;  // accumulator copies' budget
constexpr int kBlocksPerSM = 1;

enum Dtype { U8, U16, I8, I16, I32, I64, F32, BF16, U32 };
enum Kind { KIND_INT, KIND_FLOAT, KIND_BF16 };

// the layout ops/kernels.py's _PlaneSource / _PlaneSumsDesc mirror
struct Source {
  const void* values;
  const void* plus;       // FOR offset: 0-d int32 or int64, or null
  const int64_t* minus;   // the query's offset: 0-d int64, or null
  int32_t dtype, kind, nplanes, plus_is64;
  int32_t row;            // first accumulator row in its region
  int32_t pad;
};

// how each source steps per member on the member-axis entry (all zero on
// the solo entry): values of member m start m * vstride elements on, its
// query offset at minus[m * minus_mstride]
struct MemberStrides {
  int64_t vstride[kMaxSources];
  int32_t minus_mstride[kMaxSources];
};

struct PlaneSumsDesc {
  Source src[kMaxSources];
  int32_t int_out[kMaxRows];  // output row of each int32 accumulator row
  int32_t flt_out[kMaxRows];  // output row of each f64 accumulator row
  int32_t n_src, count, n_int, n_flt;
};

__device__ __forceinline__ void load_ints(const Source& s, int64_t r,
                                          int cnt, int64_t v[4]) {
  const void* p = s.values;
  if (cnt == 4) {
    switch (s.dtype) {
      case U8: {
        const uchar4 q = *reinterpret_cast<const uchar4*>(
            static_cast<const uint8_t*>(p) + r);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
      case U16: {
        const ushort4 q = *reinterpret_cast<const ushort4*>(
            static_cast<const uint16_t*>(p) + r);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
      case I8: {
        const char4 q = *reinterpret_cast<const char4*>(
            static_cast<const int8_t*>(p) + r);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
      case I16: {
        const short4 q = *reinterpret_cast<const short4*>(
            static_cast<const int16_t*>(p) + r);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
      case U32: {
        const uint4 q = *reinterpret_cast<const uint4*>(
            static_cast<const uint32_t*>(p) + r);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
      case I64: {
        const longlong2* q = reinterpret_cast<const longlong2*>(
            static_cast<const int64_t*>(p) + r);
        const longlong2 a = q[0], b = q[1];
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
        return;
      }
      default: {  // I32
        const int4 q = *reinterpret_cast<const int4*>(
            static_cast<const int32_t*>(p) + r);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
    }
  }
  // the ragged end: constant indexes only, so v stays in registers
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= cnt) {
      v[j] = 0;
      continue;
    }
    switch (s.dtype) {
      case U8: v[j] = static_cast<const uint8_t*>(p)[r + j]; break;
      case U16: v[j] = static_cast<const uint16_t*>(p)[r + j]; break;
      case I8: v[j] = static_cast<const int8_t*>(p)[r + j]; break;
      case I16: v[j] = static_cast<const int16_t*>(p)[r + j]; break;
      case U32: v[j] = static_cast<const uint32_t*>(p)[r + j]; break;
      case I64: v[j] = static_cast<const int64_t*>(p)[r + j]; break;
      default: v[j] = static_cast<const int32_t*>(p)[r + j]; break;
    }
  }
}

__device__ __forceinline__ int dtype_bytes(int dtype) {
  switch (dtype) {
    case U8: case I8: return 1;
    case U16: case I16: case BF16: return 2;
    case I64: return 8;
    default: return 4;
  }
}

__device__ __forceinline__ float bf16_bits(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ void load_floats(const Source& s, int64_t r,
                                            int cnt, float v[4]) {
  if (s.dtype == BF16) {
    const uint16_t* p = static_cast<const uint16_t*>(s.values);
    if (cnt == 4) {
      const ushort4 q = *reinterpret_cast<const ushort4*>(p + r);
      v[0] = bf16_bits(q.x); v[1] = bf16_bits(q.y);
      v[2] = bf16_bits(q.z); v[3] = bf16_bits(q.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < cnt ? bf16_bits(p[r + j]) : 0.f;
    }
    return;
  }
  const float* p = static_cast<const float*>(s.values);
  if (cnt == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + r);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < cnt ? p[r + j] : 0.f;
  }
}

// the top 16 bits of an f32: exactly a bf16 value
__device__ __forceinline__ float hi16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kThreads)
plane_sums_kernel(const int32_t* __restrict__ gid, PlaneSumsDesc d,
                  int64_t n, int G, int span, int copies, int64_t seg_rows,
                  int64_t rows_per_block, MemberStrides ms,
                  int64_t gid_mstride, int64_t out_mstride,
                  double* __restrict__ out) {
  extern __shared__ double smem[];
  __shared__ Source s_src[kMaxSources];
  __shared__ int64_t s_bias[kMaxSources];
  __shared__ int32_t s_int_out[kMaxRows];
  __shared__ int32_t s_flt_out[kMaxRows];

  // the descriptor's arrays are read at run-time indexes below: copy them
  // to shared memory with constant indexes only, so the parameter block
  // is never spilled to local memory
  const int t = threadIdx.x;
  const int64_t m = blockIdx.z;  // the member (0 on the solo entry)
  gid += m * gid_mstride;
  out += m * out_mstride;
#pragma unroll
  for (int i = 0; i < kMaxSources; ++i) {
    if (t == i) {
      Source s = d.src[i];
      int64_t b = 0;
      if (i < d.n_src) {
        s.values = static_cast<const char*>(s.values) +
                   m * ms.vstride[i] * dtype_bytes(s.dtype);
        if (s.plus != nullptr)
          b += s.plus_is64 ? *static_cast<const int64_t*>(s.plus)
                           : *static_cast<const int32_t*>(s.plus);
        if (s.minus != nullptr) b -= s.minus[m * ms.minus_mstride[i]];
      }
      s_src[i] = s;
      s_bias[i] = b;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (t == kMaxSources + i) s_int_out[i] = d.int_out[i];
    if (t == kMaxSources + kMaxRows + i) s_flt_out[i] = d.flt_out[i];
  }
  const int n_src = d.n_src, n_int = d.n_int, n_flt = d.n_flt;
  const bool count = d.count != 0;

  const int p0 = blockIdx.y * span;
  const int width = min(span, G - p0);
  const int fcells = n_flt * width;     // per copy
  const int icells = n_int * width;
  double* facc_all = smem;
  int32_t* iacc_all = reinterpret_cast<int32_t*>(smem + copies * fcells);
  const int copy = (t >> 5) % copies;
  double* facc = facc_all + copy * fcells;
  int32_t* iacc = iacc_all + copy * icells;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t b1 = min(n, b0 + rows_per_block);
  for (int64_t s0 = b0; s0 < b1; s0 += seg_rows) {
    const int64_t s1 = min(b1, s0 + seg_rows);
    __syncthreads();  // the descriptor copy, or the previous flush
    for (int i = t; i < copies * fcells; i += kThreads) facc_all[i] = 0.0;
    for (int i = t; i < copies * icells; i += kThreads) iacc_all[i] = 0;
    __syncthreads();

    for (int64_t r = s0 + 4 * static_cast<int64_t>(t); r < s1;
         r += 4 * kThreads) {
      const int cnt = static_cast<int>(min(static_cast<int64_t>(4), s1 - r));
      int rel[4];
      if (cnt == 4) {
        const int4 q = *reinterpret_cast<const int4*>(gid + r);
        rel[0] = q.x; rel[1] = q.y; rel[2] = q.z; rel[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) rel[j] = j < cnt ? gid[r + j] : -1;
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rel[j] -= p0;
        if (static_cast<unsigned>(rel[j]) >= static_cast<unsigned>(width))
          rel[j] = -1;
        any |= rel[j] >= 0;
      }
      if (!any) continue;
      if (count) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (rel[j] >= 0) atomicAdd(&iacc[rel[j]], 1);
      }
      for (int si = 0; si < n_src; ++si) {
        const Source& s = s_src[si];
        if (s.kind == KIND_INT) {
          int64_t v[4];
          load_ints(s, r, cnt, v);
          const int64_t bias = s_bias[si];
          int32_t* base = iacc + s.row * width;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (rel[j] < 0) continue;
            const int64_t x = v[j] + bias;
            for (int k = 0; k < s.nplanes; ++k) {
              const int b = static_cast<int>((x >> (8 * k)) & 0xFF);
              if (b) atomicAdd(&base[k * width + rel[j]], b);
            }
          }
        } else {
          float v[4];
          load_floats(s, r, cnt, v);
          double* base = facc + s.row * width;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (rel[j] < 0) continue;
            if (s.kind == KIND_BF16) {
              if (v[j] != 0.f) atomicAdd(&base[rel[j]], double(v[j]));
              continue;
            }
            const float m0 = hi16(v[j]);
            const float r1 = __fsub_rn(v[j], m0);
            const float m1 = hi16(r1);
            const float m2 = hi16(__fsub_rn(r1, m1));
            if (m0 != 0.f) atomicAdd(&base[rel[j]], double(m0));
            if (m1 != 0.f) atomicAdd(&base[width + rel[j]], double(m1));
            if (m2 != 0.f) atomicAdd(&base[2 * width + rel[j]], double(m2));
          }
        }
      }
    }
    __syncthreads();

    // merge the copies and flush the non-zero cells
    for (int i = t; i < icells; i += kThreads) {
      long long sum = 0;
      for (int c = 0; c < copies; ++c) sum += iacc_all[c * icells + i];
      if (sum != 0) {
        const int a = i / width;
        atomicAdd(&out[static_cast<int64_t>(s_int_out[a]) * G + p0 +
                       (i - a * width)],
                  static_cast<double>(sum));
      }
    }
    for (int i = t; i < fcells; i += kThreads) {
      double sum = 0.0;
      for (int c = 0; c < copies; ++c) sum += facc_all[c * fcells + i];
      if (sum != 0.0) {
        const int a = i / width;
        atomicAdd(&out[static_cast<int64_t>(s_flt_out[a]) * G + p0 +
                       (i - a * width)],
                  sum);
      }
    }
  }
}

}  // namespace

namespace {

// M members of n rows each; member m reads gid + m * gid_mstride and
// writes out + m * out_mstride (see the entries below)
int launch_plane_sums(const void* gid, const void* desc,
                      const MemberStrides& ms, int64_t n, int M,
                      int64_t gid_mstride, int G, int span, int64_t seg_rows,
                      int smem_budget, void* out, int64_t out_mstride,
                      void* stream) {
  const PlaneSumsDesc& d = *static_cast<const PlaneSumsDesc*>(desc);
  const int width = span < G ? span : G;
  const size_t copy_bytes =
      static_cast<size_t>(width) * (8 * d.n_flt + 4 * d.n_int);
  int copies = static_cast<int>(kCopyBytes / (copy_bytes ? copy_bytes : 1));
  copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  if (copies * copy_bytes > static_cast<size_t>(smem_budget)) copies = 1;
  const size_t smem = copies * copy_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      plane_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, plane_sums_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int parts = (G + span - 1) / span;
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
  plane_sums_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gid), d, n, G, span, copies, seg_rows,
      rows_per_block, ms, gid_mstride, out_mstride,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gid (n,) int32; desc: a PlaneSumsDesc in host memory, passed to the
// kernel by value; out (A, G) f64 zero-filled by the caller. span: groups
// per partition (its accumulators fit `smem_budget` bytes); seg_rows: the
// most rows a block adds before it flushes (a multiple of 4). Every value
// pointer must be 16-byte aligned. Returns the first CUDA error.
extern "C" int group_plane_sums(const void* gid, const void* desc, int64_t n,
                                int G, int span, int64_t seg_rows,
                                int smem_budget, void* out, void* stream) {
  const MemberStrides solo = {};
  return launch_plane_sums(gid, desc, solo, n, 1, 0, G, span, seg_rows,
                           smem_budget, out, 0, stream);
}

// The member-axis entry: gid (M, n) int32, member m's ids at
// gid + m * gid_mstride; out (M, A, G) f64 zero-filled by the caller;
// strides: a MemberStrides in host memory, how each source's values and
// query offset step per member. Every member's value pointer must be
// 16-byte aligned.
extern "C" int group_plane_sums_members(const void* gid, const void* desc,
                                        const void* strides, int64_t n, int M,
                                        int64_t gid_mstride, int G, int span,
                                        int64_t seg_rows, int smem_budget,
                                        void* out, void* stream) {
  const PlaneSumsDesc& d = *static_cast<const PlaneSumsDesc*>(desc);
  const int64_t A = d.n_int + d.n_flt;
  return launch_plane_sums(gid, desc,
                           *static_cast<const MemberStrides*>(strides), n, M,
                           gid_mstride, G, span, seg_rows, smem_budget, out,
                           A * G, stream);
}
