// Segment sum: per-record gradient rows -> per-splat sums (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/segsum.py, segment_sum_pallas (:136) and
// its body _make_segsum_kernel (:35) — the TPU kernel sums each block of
// 512 records into its window of splats as a one-hot matmul on the MXU,
// with the f32 rows split into three bf16 parts for the bf16 unit.
//
// What it computes: the gradient rows arrive sorted by compact splat id,
// so splat w (depth order) owns the slots [offsets[w], cum[w]) — its
// exclusive and inclusive record-count cumsums. For every w,
//   out[r * n + w] = sum of rows[r * pool + s] over offsets[w] <= s <
//                    min(cum[w], total),  r = 0..8,
// so a splat whose records straddle `total` (pool overflow) gets the sum
// of its live records, and one past it gets zero.
//
// Bound on the H100: bytes. Each live slot's nine floats are read once
// (36 bytes) and each splat reads 8 bytes of offsets and writes 36; one
// add per float read is far below the card's rate.
//
// Design: one warp per splat. The lanes stride over the splat's slots
// (consecutive lanes on consecutive slots, so each row's loads coalesce),
// each lane keeps nine running sums, and xor shuffles reduce them across
// the warp in a fixed order. No atomics and no cross-block state: the
// result is deterministic. The TPU kernel's one-hot bf16 split exists only
// for the MXU and has no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 9;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ rows, int pool,
              const int* __restrict__ offsets, const int* __restrict__ cum,
              const int* __restrict__ total_p, int n,
              float* __restrict__ out) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // the whole warp leaves together
  const size_t P = static_cast<size_t>(pool);
  const int lo = offsets[w];
  const int hi = min(cum[w], *total_p);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int s = lo + lane; s < hi; s += 32) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += rows[r * P + s];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    acc[r] = v;
  }
  if (lane < kRows) {
    float v = acc[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r) v = lane == r ? acc[r] : v;
    out[static_cast<size_t>(lane) * n + w] = v;
  }
}

}  // namespace

extern "C" int segsum_launch(const float* rows, int pool, const int* offsets,
                             const int* cum, const int* total, int n,
                             float* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  segsum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, pool, offsets, cum, total, n, out);
  return static_cast<int>(cudaGetLastError());
}
