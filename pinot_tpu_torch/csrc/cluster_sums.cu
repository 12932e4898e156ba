// K5: ordered per-cluster sums of the t-digest build (sm_90a).
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package
// builds a percentile digest on its host (pinot_tpu/ops/quantile_digest.py
// `compress`, through `add_values`): each centroid mean is the sequential
// float64 sum of its cluster's sorted values, starting from the first
// value, divided by the cluster's size. PERCENTILERAWTDIGEST returns the
// means through json (repr), so one ulp shows in the answer. The
// contract, bit for bit:
//
//   out[c] = ((v[s] + v[s+1]) + v[s+2]) + ... + v[e-1],  s = off[c],
//   e = off[c+1], every addition __dadd_rn, strictly in index order
//
// over the sorted values `v` (float64) and the cluster offsets `off`
// (int64, C + 1 of them); engine/sketches.py sorts the values and
// ops/digest.py schedules the clusters. An empty cluster sums to 0.0.
//
// Two regimes, chosen per cluster on the card in the same read as the sum:
//
// (a) Exact integers. Where every value of a cluster is finite and
//     integral with |v| <= 2^53, and its sum of |v| is at most 2^53,
//     every partial sum of the chain is an integer of magnitude <= 2^53,
//     so every __dadd_rn of the chain is exact and the chain's result is
//     the exact integer sum, whatever the order it is formed in. The pass
//     sums such values in uint64 (wrapping, exact when the proof holds)
//     by tiles of kTile values, a block a tile, with atomics into
//     per-cluster accumulators; the proof rides along: a flag for a value
//     that is not an integer of at most 2^53, and the sum of |v| in
//     float64 (a thread stops reading at its first value that is not
//     exact). That float sum of non-negative terms is below the true one
//     by less than a factor (1 - n 2^-53), so requiring it <= 2^52 proves
//     the true sum <= 2^53. The chain gives -0.0 only where every value
//     is -0.0 (an integer sum of 0 is +0.0), so a third flag marks a
//     value other than -0.0. Nothing goes back to the host: a finalize
//     launch writes the proven sums and compacts the long clusters left
//     into a list. Bound: bytes, 8 a value read once (0.24 ms at 100M
//     values, 3.35 TB/s), plus the offsets and three accumulators a
//     cluster.
//
// (b) The chain, for the rest (non-integral values, +-inf, NaN, integers
//     past 2^53, a sum of |v| past 2^52). A cluster of at most kShort
//     values is chained by the finalize's own thread for it, 16 values
//     loaded ahead of their adds. A longer one is listed, and gets a
//     block of two warps in the last launch: lane 0 of warp 1 streams the
//     cluster's 16-byte-aligned body through a ring of kStages
//     shared-memory stages with TMA bulk copies (cp.async.bulk, an
//     mbarrier a stage for "full" and one for "empty"), and lane 0 of
//     warp 0 does nothing but the dependent chain, reading its next 16
//     values from shared memory into registers ahead of their adds. The
//     bound is the longest chain cluster times one DADD's latency
//     (kernel_ab.py --k5-only measures it with `dadd_chain`, a one-thread
//     dependent-add micro).
//
// Times (kernel_ab.py --k5-only, NVIDIA H100 80GB HBM3 at 700 W, CUDA
// events, this design against the former in one call, each twice): at
// pct_scalar's clusters (808, the longest 196,317 values, integers)
// 0.2700 / 0.2705 ms, against 2.9110 / 2.9121 for the former design,
// which ran every long cluster's chain on a whole warp (a __shfl_sync, a
// compare and a predicated add on all 32 lanes a value), and 0.37-0.42
// for torch.segment_reduce; the same clusters + 0.5 (the block chain)
// 1.1130 / 1.0995 against a chain bound of 0.7965 (2.9218 / 2.9181
// before); pct_tdigest_supp's 816,000 clusters 0.3744 / 0.3715 (0.5019
// / 0.5024 before), and + 0.5 (the lane chains, after an exact pass that
// reads every short run) 0.7885 / 0.7887 (0.5009 / 0.5021 before);
// pct_raw_month's 0.0661 / 0.0508 (0.0700 / 0.0690 before), bound by
// the host's enqueue of four launches (44-62 us; 16 us on the card).
// chip_smoke.py's times at the captured inputs are in PERF.md's kernel
// table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShort = 256;               // longest cluster a lane chains
constexpr int kLaneChunk = 16;            // values a lane loads ahead
constexpr int kTile = 8192;               // values an exact-pass block reads
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kWide = 1024;               // a tile's run this long: the block
constexpr int kNarrowAhead = 8;           // loads ahead a lane, shorter runs
constexpr int kFinalThreads = 256;
constexpr int kStages = 4;                // TMA ring stages
constexpr int kStageVals = 1024;          // 8 KB a stage
constexpr int kGroup = 8;                 // value pairs loaded ahead
constexpr int kChainThreads = 64;         // warp 0 adds, warp 1 loads
constexpr int kChainBlocks = 132 * 7;     // 7 rings of 32 KB an SM
constexpr double kMaxAbs = 9007199254740992.0;     // 2^53
constexpr double kMaxSumAbs = 4503599627370496.0;  // 2^52
constexpr unsigned kNotExact = 1u;        // a value that is not an integer
constexpr unsigned kNotNegZero = 2u;      // a value other than -0.0

// the per-call scratch, carved from one allocation of the wrapper's
struct Scratch {
  unsigned long long* isum;  // (C,) the exact pass's integer sums
  double* asum;              // (C,) its float64 sums of |v|
  unsigned* flags;           // (C,) kNotExact | kNotNegZero
  int* list;                 // (C,) the clusters the block chain sums
  int* tile_first;           // (tiles,) the cluster holding a tile's start
  int* counts;               // [the list's length]
};

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

int64_t align8(int64_t b) { return (b + 7) & ~int64_t{7}; }

int64_t scratch_bytes(int64_t n, int64_t C) {
  return align8(16 * C + 8 * C + 4 * tiles_of(n) + 16);
}

Scratch carve(void* base, int64_t n, int64_t C) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.isum = reinterpret_cast<unsigned long long*>(p);
  s.asum = reinterpret_cast<double*>(p + 8 * C);
  s.flags = reinterpret_cast<unsigned*>(p + 16 * C);
  s.list = reinterpret_cast<int*>(p + 20 * C);
  s.tile_first = reinterpret_cast<int*>(p + 24 * C);
  s.counts = reinterpret_cast<int*>(p + 24 * C + 4 * tiles_of(n));
  return s;
}

// ---- the exact integer regime ---------------------------------------------

struct Part {  // a run's partials
  unsigned long long isum;
  double asum;
  unsigned flags;
};

__device__ __forceinline__ void take(Part& p, double x) {
  const bool ok = fabs(x) <= kMaxAbs && x == trunc(x);
  p.flags |= ok ? 0u : kNotExact;
  p.flags |= (x == 0.0 && signbit(x)) ? 0u : kNotNegZero;
  p.isum += ok ? static_cast<unsigned long long>(__double2ll_rz(x)) : 0ull;
  p.asum += fabs(x);
}

__device__ __forceinline__ Part warp_total(Part p) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    p.isum += __shfl_down_sync(0xffffffffu, p.isum, d);
    p.asum += __shfl_down_sync(0xffffffffu, p.asum, d);
    p.flags |= __shfl_down_sync(0xffffffffu, p.flags, d);
  }
  return p;
}

__device__ __forceinline__ void commit(const Scratch& s, int c, Part p) {
  atomicAdd(s.isum + c, p.isum);
  atomicAdd(s.asum + c, p.asum);
  atomicOr(s.flags + c, p.flags);
}

// zero the accumulators and the counts; the cluster holding each tile's
// first value (the last c with off[c] <= t0; -1 before every cluster)
__global__ void k5_prepare(const int64_t* __restrict__ off, int64_t C,
                           int64_t tiles, Scratch s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i == 0) s.counts[0] = 0;
  if (i < C) {
    s.isum[i] = 0;
    s.asum[i] = 0.0;
    s.flags[i] = 0;
  }
  if (i < tiles) {
    const int64_t t0 = i * kTile;
    int64_t lo = 0, hi = C;  // count the clusters starting at or before t0
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (off[mid] <= t0) lo = mid + 1;
      else hi = mid;
    }
    s.tile_first[i] = static_cast<int>(lo - 1);
  }
}

// one block a tile [t0, t1): the block lists the clusters meeting the
// tile, sums each run of kWide values or more with all its threads and
// the shorter runs a warp each, and adds the partials into the cluster's
// accumulators
__global__ void __launch_bounds__(kTileThreads)
k5_exact_pass(const double* __restrict__ v, const int64_t* __restrict__ off,
              int64_t C, int64_t n, Scratch s) {
  __shared__ int wide[kTile / kWide + 1];
  __shared__ int narrow[kTile];
  __shared__ int n_wide, n_narrow;
  __shared__ Part warp_parts[kTileWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t t1 = t0 + kTile < n ? t0 + kTile : n;
  if (tid == 0) n_wide = n_narrow = 0;
  __syncthreads();
  const int64_t c0 = s.tile_first[blockIdx.x] < 0 ? 0
                                                  : s.tile_first[blockIdx.x];
  for (int64_t c = c0 + tid; c < C; c += kTileThreads) {
    const int64_t a = off[c], e = off[c + 1];
    if (a >= t1) break;  // offsets rise: no later cluster meets the tile
    const int64_t lo = a > t0 ? a : t0;
    const int64_t len = (e < t1 ? e : t1) - lo;
    if (len <= 0) continue;
    if (len >= kWide) wide[atomicAdd(&n_wide, 1)] = static_cast<int>(c);
    else narrow[atomicAdd(&n_narrow, 1)] = static_cast<int>(c);
  }
  __syncthreads();
  for (int w = 0; w < n_wide; ++w) {  // the same count on every thread
    const int c = wide[w];
    const int64_t lo = off[c] > t0 ? off[c] : t0;
    const int64_t hi = off[c + 1] < t1 ? off[c + 1] : t1;
    Part p{0ull, 0.0, 0u};
    int64_t i = lo + tid;
    // a thread stops reading at its first value that is not exact: the
    // cluster is chained then, and its partials are not read
    for (; i + 3 * kTileThreads < hi && !(p.flags & kNotExact);
         i += 4 * kTileThreads) {
      const double x0 = __ldg(v + i), x1 = __ldg(v + i + kTileThreads),
                   x2 = __ldg(v + i + 2 * kTileThreads),
                   x3 = __ldg(v + i + 3 * kTileThreads);
      take(p, x0);
      take(p, x1);
      take(p, x2);
      take(p, x3);
    }
    for (; i < hi && !(p.flags & kNotExact); i += kTileThreads)
      take(p, __ldg(v + i));
    p = warp_total(p);
    if (lane == 0) warp_parts[warp] = p;
    __syncthreads();
    if (tid == 0) {
      Part t = warp_parts[0];
      for (int k = 1; k < kTileWarps; ++k) {
        t.isum += warp_parts[k].isum;
        t.asum += warp_parts[k].asum;
        t.flags |= warp_parts[k].flags;
      }
      commit(s, c, t);
    }
    __syncthreads();
  }
  for (int k = warp; k < n_narrow; k += kTileWarps) {
    const int c = narrow[k];
    const int64_t lo = off[c] > t0 ? off[c] : t0;
    const int64_t hi = off[c + 1] < t1 ? off[c + 1] : t1;
    Part p{0ull, 0.0, 0u};
    // kNarrowAhead loads in flight a lane: a run of up to 256 values is
    // one round trip to memory
    for (int64_t i = lo + lane; i < hi && !(p.flags & kNotExact);
         i += kNarrowAhead * 32) {
      double x[kNarrowAhead];
#pragma unroll
      for (int j = 0; j < kNarrowAhead; ++j)
        x[j] = i + j * 32 < hi ? __ldg(v + i + j * 32) : 0.0;
#pragma unroll
      for (int j = 0; j < kNarrowAhead; ++j)
        if (i + j * 32 < hi) take(p, x[j]);
    }
    p = warp_total(p);
    if (lane == 0) commit(s, c, p);
  }
}

// ---- the chain regime -----------------------------------------------------

// v[s] + v[s+1] + ... + v[e-1] in index order, s < e, by one thread.
__device__ double lane_sum(const double* __restrict__ v, int64_t s,
                           int64_t e) {
  double acc = v[s];  // compress starts from the first value
  int64_t i = s + 1;
  for (; i + kLaneChunk <= e; i += kLaneChunk) {
    double x[kLaneChunk];
#pragma unroll
    for (int j = 0; j < kLaneChunk; ++j) x[j] = __ldg(v + i + j);
#pragma unroll
    for (int j = 0; j < kLaneChunk; ++j) acc = __dadd_rn(acc, x[j]);
  }
  for (; i < e; ++i) acc = __dadd_rn(acc, __ldg(v + i));
  return acc;
}

// write each proven cluster's sum, and chain each other cluster of at
// most kShort values in its own thread; list the longer ones for the
// block chain; add the regime counts to the caller's running totals
__global__ void __launch_bounds__(kFinalThreads)
k5_finalize(const double* __restrict__ v, const int64_t* __restrict__ off,
            int64_t C, double* __restrict__ out, Scratch s,
            unsigned long long* __restrict__ regimes) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool exact = false, lane_chain = false, block_chain = false;
  int64_t st = 0, e = 0;
  if (c < C) {
    st = off[c];
    e = off[c + 1];
    const unsigned f = s.flags[c];
    if (e <= st) {
      out[c] = 0.0;
      exact = true;
    } else if (!(f & kNotExact) && s.asum[c] <= kMaxSumAbs) {
      out[c] = (f & kNotNegZero)
                   ? static_cast<double>(static_cast<long long>(s.isum[c]))
                   : -0.0;
      exact = true;
    } else {
      lane_chain = e - st <= kShort;
      block_chain = !lane_chain;
    }
  }
  const unsigned em = __ballot_sync(0xffffffffu, exact);
  const unsigned lm = __ballot_sync(0xffffffffu, lane_chain);
  const unsigned bm = __ballot_sync(0xffffffffu, block_chain);
  // a warp-aggregated append of the block chains to the list
  const int leader = bm != 0u ? __ffs(bm) - 1 : 0;
  int base = 0;
  if (bm != 0u && lane == leader) base = atomicAdd(s.counts, __popc(bm));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (block_chain)
    s.list[base + __popc(bm & ((1u << lane) - 1u))] = static_cast<int>(c);
  if (lane == 0) {
    if (em) atomicAdd(regimes, static_cast<unsigned long long>(__popc(em)));
    if (lm) atomicAdd(regimes + 1,
                      static_cast<unsigned long long>(__popc(lm)));
    if (bm) atomicAdd(regimes + 2,
                      static_cast<unsigned long long>(__popc(bm)));
  }
  if (lane_chain) out[c] = lane_sum(v, st, e);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a TMA bulk copy of `bytes` (a multiple of 16, both ends 16-aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void load_group(double2 (&r)[kGroup],
                                           const double2* p, int g) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) r[j] = p[g * kGroup + j];
}

__device__ __forceinline__ double add_group(double acc,
                                            const double2 (&r)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    acc = __dadd_rn(acc, r[j].x);
    acc = __dadd_rn(acc, r[j].y);
  }
  return acc;
}

// acc + buf[0] + ... + buf[cnt - 1] in order, cnt even: the next 16
// values are in registers before the current 16 are added
__device__ __forceinline__ double add_stage(double acc,
                                            const double* buf,
                                            int cnt) {
  const double2* p = reinterpret_cast<const double2*>(buf);
  const int pairs = cnt >> 1;
  const int groups = pairs / kGroup;
  double2 ra[kGroup], rb[kGroup];
  if (groups > 0) load_group(ra, p, 0);
  for (int g = 0; g < groups;) {
    if (g + 1 < groups) load_group(rb, p, g + 1);
    acc = add_group(acc, ra);
    if (++g >= groups) break;
    if (g + 1 < groups) load_group(ra, p, g + 1);
    acc = add_group(acc, rb);
    ++g;
  }
  for (int i = groups * kGroup; i < pairs; ++i) {
    const double2 x = p[i];
    acc = __dadd_rn(acc, x.x);
    acc = __dadd_rn(acc, x.y);
  }
  return acc;
}

// the listed clusters of more than kShort values, a block each in turn:
// thread 32 streams each cluster's aligned body into the ring, thread 0
// chains it. Both walk the same clusters, so their running chunk counts
// name the same stage and phase.
__global__ void __launch_bounds__(kChainThreads)
k5_chain_blocks(const double* __restrict__ v,
                const int64_t* __restrict__ off, int64_t C,
                double* __restrict__ out, Scratch s) {
  __shared__ __align__(128) double ring[kStages][kStageVals];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int tid = threadIdx.x;
  const int count = s.counts[0];
  if (static_cast<int>(blockIdx.x) >= count) return;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid != 0 && tid != 32) return;
  uint32_t chunk = 0;
  for (int k = blockIdx.x; k < count; k += gridDim.x) {
    const int c = s.list[k];
    const int64_t st = off[c], e = off[c + 1];
    // [st + 1, a) before the 16-aligned body [a, b), [b, e) after it
    int64_t a = st + 1;
    if (reinterpret_cast<uintptr_t>(v + a) & 15) ++a;
    if (a > e) a = e;
    const int64_t b = a + ((e - a) & ~int64_t{1});
    const int64_t chunks = (b - a + kStageVals - 1) / kStageVals;
    if (tid == 32) {
      for (int64_t q = 0; q < chunks; ++q, ++chunk) {
        const uint32_t stage = chunk % kStages, round = chunk / kStages;
        if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
        const int64_t from = a + q * kStageVals;
        const int64_t cnt = b - from < kStageVals ? b - from : kStageVals;
        const uint32_t bytes = static_cast<uint32_t>(cnt * 8);
        mbar_expect_tx(&full[stage], bytes);
        bulk_load(ring[stage], v + from, bytes, &full[stage]);
      }
    } else {
      double acc = v[st];  // compress starts from the first value
      for (int64_t i = st + 1; i < a; ++i) acc = __dadd_rn(acc, v[i]);
      for (int64_t q = 0; q < chunks; ++q, ++chunk) {
        const uint32_t stage = chunk % kStages, round = chunk / kStages;
        mbar_wait(&full[stage], round & 1);
        const int64_t from = a + q * kStageVals;
        const int cnt =
            static_cast<int>(b - from < kStageVals ? b - from : kStageVals);
        acc = add_stage(acc, ring[stage], cnt);
        mbar_arrive(&empty[stage]);
      }
      for (int64_t i = b; i < e; ++i) acc = __dadd_rn(acc, v[i]);
      out[c] = acc;
    }
  }
}

// one thread: n dependent additions, alternating two addends; out[0] the
// sum (so nothing is folded away), out[1] the clock cycles an addition
__global__ void dadd_chain_kernel(const double* __restrict__ x, int64_t n,
                                  double* __restrict__ out) {
  double acc = x[0];
  const double p = x[1], q = x[2];
  const long long t0 = clock64();
  for (int64_t i = 0; i < n; i += 8) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = __dadd_rn(acc, p);
      acc = __dadd_rn(acc, q);
    }
  }
  const long long t1 = clock64();
  out[0] = acc;
  out[1] = static_cast<double>(t1 - t0) / static_cast<double>(n);
}

}  // namespace

// Bytes of scratch `cluster_sums` needs for n values and C clusters.
extern "C" int64_t cluster_sums_scratch(int64_t n, int64_t C) {
  return scratch_bytes(n, C);
}

// v: (n,) float64 sorted values; off: (C + 1,) int64 cluster offsets into
// v; out: (C,) float64; scratch: cluster_sums_scratch(n, C) bytes;
// regimes: (3,) int64 running totals of the clusters each regime summed
// (exact, lane chain, block chain). Four launches on `stream`; returns
// the first launch's cudaError_t that is not 0 (0 = success).
extern "C" int cluster_sums(const void* v, int64_t n, const void* off,
                            int64_t C, void* out, void* scratch,
                            void* regimes, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* vals = static_cast<const double*>(v);
  const int64_t* offs = static_cast<const int64_t*>(off);
  double* o = static_cast<double*>(out);
  const Scratch s = carve(scratch, n, C);
  const int64_t tiles = tiles_of(n);
  const int64_t most = C > tiles ? C : tiles;
  k5_prepare<<<static_cast<unsigned>((most + 255) / 256), 256, 0, st>>>(
      offs, C, tiles, s);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  if (tiles > 0) {
    k5_exact_pass<<<static_cast<unsigned>(tiles), kTileThreads, 0, st>>>(
        vals, offs, C, n, s);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  }
  k5_finalize<<<static_cast<unsigned>((C + kFinalThreads - 1) /
                                      kFinalThreads),
                kFinalThreads, 0, st>>>(
      vals, offs, C, o, s, static_cast<unsigned long long*>(regimes));
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  // a persistent grid, every block resident at once; it reads the list's
  // length on the card
  const int64_t blocks = C < kChainBlocks ? C : kChainBlocks;
  k5_chain_blocks<<<static_cast<unsigned>(blocks), kChainThreads, 0, st>>>(
      vals, offs, C, o, s);
  return static_cast<int>(cudaGetLastError());
}

// The DADD latency micro: n (a multiple of 8) dependent additions by one
// thread from x[0], adding x[1] and x[2] in turn; out[0] the sum, out[1]
// the cycles an addition (clock64). Returns the launch's cudaError_t.
extern "C" int dadd_chain(const void* x, int64_t n, void* out,
                          void* stream) {
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), n, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
