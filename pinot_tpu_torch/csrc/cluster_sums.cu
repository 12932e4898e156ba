// K5: ordered per-cluster sums of the t-digest build (sm_90a).
//
// A port-only kernel: it replaces no Pallas kernel. The JAX package
// builds a percentile digest on its host (pinot_tpu/ops/quantile_digest.py
// `compress`, through `add_values`): each centroid mean is the sequential
// float64 sum of its cluster's sorted values, starting from the first
// value, divided by the cluster's size. PERCENTILERAWTDIGEST returns the
// means through json (repr), so one ulp shows in the answer, and no torch
// op on CUDA sums in a fixed sequential order (cumsum, index_add_ and
// segment_reduce are parallel). This kernel does:
//
//   out[c] = ((v[s] + v[s+1]) + v[s+2]) + ... + v[e-1],  s = off[c],
//   e = off[c+1], every addition __dadd_rn, strictly in index order
//
// over the sorted values `v` (float64) and the cluster offsets `off`
// (int64, C + 1 of them, every cluster non-empty); engine/sketches.py
// sorts the values and ops/digest.py schedules the clusters.
//
// What bounds it on an H100: bytes, 8 per value read once (800 MB at
// 100M values: 0.24 ms at 3.35 TB/s), but the order is a dependent chain
// of float64 additions, so the largest cluster (about pi/delta of its run:
// ~196,000 values at 12.5M rows and delta = 200) sets the time at one add
// latency a value.
//
// Design: a cluster of at most kShort values is summed by one lane
// alone, 16 values loaded ahead of their adds; a longer one by a whole
// warp, which loads 256 values at a time, 8 a lane in coalesced rows,
// while it adds the previous 256: the next chunk's loads are in flight
// during the chain, so the chain's add latency and not the memory
// latency is what each value costs. In the warp's chain every lane
// reads each value of the chunk in order with __shfl_sync and adds it to
// its own copy of the sum, so all 32 copies are the same sum in the same
// order; lane 0 writes it. Warp w takes the short clusters 32w..32w+31,
// a lane each, then cluster w if it is long. Neither form alone wins
// both ways (kernel_ab.py --k5-only, NVIDIA H100 80GB HBM3 at 700 W):
// at pct_scalar's clusters (808, the longest 196,317 values) one lane
// per cluster took 4.94 ms, one warp per cluster 3.12 and this kernel
// 2.92; over 816,000 clusters of at most 196 values (pct_tdigest_supp)
// 0.33, 1.91 (a warp idles through a 256-value chunk for each) and 0.50.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kPerLane = 8;               // values a lane holds a chunk
constexpr int kChunk = 32 * kPerLane;     // values a warp holds a chunk
constexpr int kShort = kChunk;            // longest cluster a lane sums
constexpr int kLaneChunk = 16;            // values a lane loads ahead

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

__global__ void __launch_bounds__(kWarps * 32)
cluster_sums_kernel(const double* __restrict__ v,
                    const int64_t* __restrict__ off, int64_t C,
                    double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  // the short clusters 32w .. 32w + 31, a lane each
  const int64_t c = w * 32 + lane;
  if (c < C) {
    const int64_t s = off[c];
    const int64_t e = off[c + 1];
    if (e - s <= kShort) out[c] = s < e ? lane_sum(v, s, e) : 0.0;
  }
  // cluster w, when it is long: the whole warp (w is the warp's)
  if (w >= C) return;
  const int64_t s = off[w];
  const int64_t e = off[w + 1];
  if (e - s <= kShort) return;
  double acc = v[s];  // compress starts from the first value
  int64_t base = s + 1;
  double cur[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int64_t i = base + j * 32 + lane;
    cur[j] = i < e ? v[i] : 0.0;
  }
  while (base < e) {
    const int64_t next = base + kChunk;
    double nxt[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t i = next + j * 32 + lane;
      nxt[j] = i < e ? v[i] : 0.0;
    }
    const int64_t left = e - base;  // values of this chunk that exist
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const double x = __shfl_sync(0xffffffffu, cur[j], l);
        if (j * 32 + l < left) acc = __dadd_rn(acc, x);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) cur[j] = nxt[j];
    base = next;
  }
  if (lane == 0) out[w] = acc;
}

}  // namespace

// v: (n,) float64 sorted values; off: (C + 1,) int64 cluster offsets into
// v; out: (C,) float64. Returns the launch's cudaError_t (0 = success).
extern "C" int cluster_sums(const void* v, const void* off, int64_t C,
                            void* out, void* stream) {
  if (C <= 0) return 0;
  const int64_t blocks = (C + kWarps - 1) / kWarps;  // a warp a cluster
  cluster_sums_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(v), static_cast<const int64_t*>(off), C,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
