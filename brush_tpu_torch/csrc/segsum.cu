// Segment sum: per-record gradient rows -> per-splat sums (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/segsum.py, segment_sum_pallas (:136) and
// its body _make_segsum_kernel (:35) — the TPU kernel sums each block of
// 512 records into its window of splats as a one-hot matmul on the MXU,
// with the f32 rows split into three bf16 parts for the bf16 unit.
//
// What it computes: the gradient rows arrive sorted by compact splat id,
// so splat w (depth order) owns the slots [offsets[w], cum[w]) — its
// exclusive and inclusive record-count cumsums, so offsets[w + 1] ==
// cum[w] and the slots of consecutive splats are one contiguous range.
// For every w,
//   out[r * n + w] = sum of rows[r * pool + s] over offsets[w] <= s <
//                    min(cum[w], total),  r = 0..8,
// so a splat whose records straddle `total` (pool overflow) gets the sum
// of its live records, and one past it gets zero.
//
// Bound on the H100: bytes. Each live slot's nine floats are read once
// (36 bytes) and each splat reads 8 bytes of offsets and writes 36; one
// add per float read is far below the card's rate.
//
// What held the first version back: it gave one warp to every row of the
// capacity. A training run keeps the capacity at a multiple of the live
// splats and a live splat owns about two slots, so each warp paid two
// dependent scalar loads, 45 shuffles and a nine-way select for at most
// two useful lanes, and stored nine lone floats into nine 32-byte
// sectors. It was bound by issue slots, not by bytes, and one
// index_add_ call beat it five times over.
//
// Design: a block-wide segmented sum over contiguous slot ranges.
//   - A block of 256 threads owns 256 consecutive splats, one a thread.
//     Their slots are the contiguous range [offsets[w0], min(cum[w_last],
//     total)). A block whose range is empty (all padding rows, or all
//     past `total`) stores its 9 x 256 zeros coalesced and leaves.
//   - Otherwise the range streams through shared memory in chunks of 512
//     slots x 9 rows, two stages filled by cp.async (16 bytes a copy when
//     the pool's rows are 16-byte aligned, else 4), so the next chunk
//     loads while this one is summed. Every live slot is read from device
//     memory once, coalesced.
//   - Each thread adds its own splat's part of the chunk from shared
//     memory, in slot order, into nine registers carried across chunks.
//   - A part longer than 64 slots (a splat covering thousands of tiles) is
//     summed by the whole block instead: the eight warps take eighths of
//     it, lanes stride over the slots, a fixed xor tree reduces each warp,
//     and the owner adds the eight partials in warp order.
//   - out[r * n + w] is stored by consecutive threads: coalesced.
// No atomics on floats, no cross-block state, a fixed order of summation:
// two launches on the same inputs are bit-equal. (The one shared-memory
// atomic hands out list positions for long parts; each part's sum does
// not depend on its position.) The TPU kernel's one-hot bf16 split exists
// only for the MXU and has no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 9;
constexpr int kChunk = 512;  // slots a stage
constexpr int kLong = 64;    // a longer part of a chunk is summed by the block
constexpr int kMaxLong = kChunk / (kLong + 1) + 1;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kVec: floats a copy (4 when every row of the pool is 16-byte aligned).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ rows, int pool,
              const int* __restrict__ offsets, const int* __restrict__ cum,
              const int* __restrict__ total_p, int n,
              float* __restrict__ out) {
  __shared__ __align__(16) float s_rows[2][kRows][kChunk];
  __shared__ float s_part[kMaxLong][kWarps][kRows];
  __shared__ int s_long_lo[kMaxLong], s_long_hi[kMaxLong];
  __shared__ int s_nlong;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w0 = blockIdx.x * kThreads;
  const int w = w0 + tid;
  const size_t P = static_cast<size_t>(pool);
  const size_t N = static_cast<size_t>(n);
  const int total = min(*total_p, pool);

  // The block's slots: one contiguous range.
  const int blo = offsets[w0];
  const int bhi = min(cum[min(w0 + kThreads, n) - 1], total);
  if (bhi <= blo) {
    if (w < n) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[r * N + w] = 0.0f;
    }
    return;
  }

  int lo = 0, hi = 0;
  if (w < n) {
    lo = offsets[w];
    hi = min(cum[w], total);
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  // Chunk c covers the slots [a0 + c * kChunk, ...) cut at bhi; a0 is blo
  // rounded down to a copy's width, so every copy is aligned.
  const int a0 = blo - blo % kVec;
  auto stage = [&](int c0, int st) {
    constexpr int kGroups = kChunk / kVec;  // copies a row
    const int groups = (min(c0 + kChunk, bhi) - c0 + kVec - 1) / kVec;
    for (int i = tid; i < kRows * kGroups; i += kThreads) {
      const int r = i / kGroups;
      const int g = i % kGroups;
      if (g < groups) {
        cp_async<4 * kVec>(&s_rows[st][r][g * kVec],
                           rows + r * P + c0 + g * kVec);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) s_nlong = 0;
  stage(a0, 0);
  int st = 0;
  for (int c0 = a0; c0 < bhi; c0 += kChunk, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk c0 is in s_rows[st]; the other stage is free
    if (c0 + kChunk < bhi) stage(c0 + kChunk, st ^ 1);

    const int c1 = min(c0 + kChunk, bhi);
    const int a = max(lo, c0) - c0;
    const int b = min(hi, c1) - c0;
    bool is_long = false;
    int q = 0;
    if (b - a > kLong) {
      is_long = true;
      q = atomicAdd(&s_nlong, 1);
      s_long_lo[q] = a;
      s_long_hi[q] = b;
    } else {
      for (int s = a; s < b; ++s) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += s_rows[st][r][s];
      }
    }

    const int n_long = __syncthreads_count(is_long);
    if (n_long == 0) continue;  // block-uniform
    if (tid == 0) s_nlong = 0;
    for (int e = 0; e < n_long; ++e) {
      const int ea = s_long_lo[e];
      const int eb = s_long_hi[e];
      const int per = (eb - ea + kWarps - 1) / kWarps;
      const int wa = ea + warp * per;
      const int wb = min(eb, wa + per);
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
      for (int s = wa + lane; s < wb; s += 32) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] += s_rows[st][r][s];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v[r] += __shfl_xor_sync(kFull, v[r], o);
        }
        if (lane == 0) s_part[e][warp][r] = v[r];
      }
    }
    __syncthreads();
    if (is_long) {
      for (int k = 0; k < kWarps; ++k) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += s_part[q][k][r];
      }
    }
  }

  if (w < n) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * N + w] = acc[r];
  }
}

}  // namespace

extern "C" int segsum_launch(const float* rows, int pool, const int* offsets,
                             const int* cum, const int* total, int n,
                             float* out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      pool % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (aligned) {
    segsum_kernel<4><<<blocks, kThreads, 0, s>>>(rows, pool, offsets, cum,
                                                 total, n, out);
  } else {
    segsum_kernel<1><<<blocks, kThreads, 0, s>>>(rows, pool, offsets, cum,
                                                 total, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
