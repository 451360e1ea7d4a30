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
// Two kernels, chosen by the host from n (the wrapper reads nothing from
// the device, so its calls replay from a CUDA graph): from kSplatMinSplats
// = 131072 splats, 512 blocks of the splat kernel, that kernel; below, the
// span kernel. Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, row
// 4; scripts/torch_kernel_variants.py): at the bench's 4M training
// arguments the splat kernel takes 0.088 ms and the span kernel 0.097; at
// the CLI's (8192 splats) the span kernel 0.010 and the splat kernel
// 0.111, against index_add_'s 0.041; on the bench's slots with every 8
// splats merged into one (n 131072) the splat kernel 0.038 and the span
// kernel 0.048, with every 16 (n 65536) 0.057 and 0.048: the splat kernel
// loses once its blocks no longer fill the SMs several times over, not
// with the slots a splat.
//
// The splat kernel (the earlier design): a block of 256 threads owns 256
// consecutive splats, one a thread. Their slots are the contiguous range
// [offsets[w0], min(cum[w_last], total)); a block whose range is empty
// stores its 9 x 256 zeros coalesced and leaves. Otherwise the range
// streams through shared memory in chunks of 512 slots x 9 rows, two
// stages filled by cp.async, and each thread adds its own splat's part of
// a chunk in slot order into nine registers carried across chunks; a
// part longer than 64 slots is summed by the whole block (the eight warps
// take eighths of it, a fixed xor tree, the owner adds the eight partials
// in warp order). It has no search to make and moves each byte once, but
// a block walks its whole slot range alone, chunk after chunk, each chunk
// a cp.async wait and two or three barriers: with few splats (the CLI:
// 8192 splats, about 120k live slots, some splats owning thousands) that
// was 32 blocks for 132 SMs, the dozen holding live splats running as a
// dozen serial chains.
//
// The span kernel splits the work by slots, not by splats.
//   - Span blocks. Block b < ceil(pool / kSpan) owns the slots [b kSpan,
//     (b + 1) kSpan) cut at `total` (read on the device; blocks past it
//     leave at once), so the live slots spread over as many blocks as they
//     fill, whatever the splats. A block stages its span's nine rows in
//     shared memory by cp.async (16 bytes a copy when the pool's rows are
//     16-byte aligned, else 4) and, while they arrive, finds the splats
//     that start in its span with one block-wide search of offsets (each
//     round every thread loads a probe and __syncthreads_count narrows the
//     range 257-fold); then it sums each splat's part of the span in slot
//     order: a thread a splat for parts of up to kLong slots, a warp a part
//     for longer ones (lanes stride over the slots, a fixed xor tree).
//   - A splat inside one span is written by its block. A splat that
//     crosses spans leaves one partial a span: in its first span as the
//     span's `tail`, in every later one as the span's `head` (a splat that
//     covers a whole span is its head). A second kernel, a thread a span,
//     finds the spans in which a crossing splat ends and adds its partials
//     in span order, tail first.
//   - Zero blocks. The splats that start at or past `total` (padding rows
//     of a capacity) get zeros from ceil(n / kZero) blocks, each checking
//     its first and last splat's offset before any per-splat read. Span
//     and zero blocks alternate in the grid.
//   The search and the per-splat loads of offsets and cum make a span
//   block a longer chain of dependent loads than a splat block, which is
//   why it loses where the splat blocks are many.
// No atomics on floats, a fixed order of summation everywhere: two
// launches on the same inputs are bit-equal. (A shared-memory atomic hands
// out list positions for long parts; a part's sum does not depend on its
// position.) The TPU kernel's one-hot bf16 split exists only for the MXU
// and has no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 9;
constexpr int kLong = 64;  // a longer part: a warp (span), the block (splat)
// The span kernel.
constexpr int kSpan = 1024;  // slots a span block
constexpr int kMaxLong = kSpan / (kLong + 1) + 1;
constexpr int kZero = 1024;  // splats a zero block
// The splat kernel.
constexpr int kChunk = 512;  // slots a stage
constexpr int kChunkLong = kChunk / (kLong + 1) + 1;
// From this many splats (512 splat blocks, about 4 an SM) the splat
// kernel runs (see the header).
constexpr int kSplatMinSplats = 131072;
constexpr int kJoinThreads = 128;
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

// Probe i in [0, kThreads) of a search over [lo, lo + span), span >
// kThreads: the probes cut the range into kThreads + 1 parts.
__device__ __forceinline__ int probe(int lo, int span, int i) {
  return lo + static_cast<int>(static_cast<long long>(i + 1) * span /
                               (kThreads + 1));
}

// For q = 0, 1: the first w in [0, n) with a[w] > s[q], or n, into lo[q]
// (a nondecreasing), as expand.cu's search: each round every thread loads
// one probe of each search and __syncthreads_count says how many probes
// lie at or below s[q]. Invariant: the answer lies in [lo, hi], and
// hi == n or a[hi] > s.
__device__ void block_first_above(const int* __restrict__ a, int n,
                                  const int (&s)[2], int (&lo)[2]) {
  const int t = threadIdx.x;
  int hi[2] = {n, n};
  lo[0] = lo[1] = 0;
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    bool le[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int span = hi[q] - lo[q];
      const bool wide = span > kThreads;
      le[q] = (wide || t < span) &&
              a[wide ? probe(lo[q], span, t) : lo[q] + t] <= s[q];
    }
    const int c[2] = {__syncthreads_count(le[0]), __syncthreads_count(le[1])};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int span = hi[q] - lo[q];
      if (span > kThreads) {
        const int nlo = c[q] == 0 ? lo[q] : probe(lo[q], span, c[q] - 1) + 1;
        hi[q] = c[q] == kThreads ? hi[q] : probe(lo[q], span, c[q]);
        lo[q] = nlo;
      } else {
        lo[q] = hi[q] = lo[q] + c[q];
      }
    }
  }
}

// The span kernel. kVec: floats a copy (4 when every row of the pool is
// 16-byte aligned). head, tail: kRows floats a span block; cross: an int a
// span block, the splat that enters the span from an earlier one, or -1.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
segsum_span_kernel(const float* __restrict__ rows, int pool,
                   const int* __restrict__ offsets,
                   const int* __restrict__ cum,
                   const int* __restrict__ total_p, int n, int span_blocks,
                   float* __restrict__ out, float* __restrict__ head,
                   float* __restrict__ tail, int* __restrict__ cross) {
  __shared__ __align__(16) float s_rows[kRows][kSpan];
  __shared__ float s_part[kMaxLong][kRows];
  __shared__ int s_long_lo[kMaxLong], s_long_hi[kMaxLong];
  __shared__ int s_nlong;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t P = static_cast<size_t>(pool);
  const size_t N = static_cast<size_t>(n);
  const int total = min(*total_p, pool);

  // Span and zero blocks alternate while both last, so the span blocks'
  // searches and staging overlap the zero blocks' stores.
  const int zero_blocks = (n + kZero - 1) / kZero;
  const int both = min(span_blocks, zero_blocks);
  const int bid = blockIdx.x;
  const bool is_zero = bid < 2 * both ? (bid & 1) : span_blocks < zero_blocks;
  const int index = bid < 2 * both ? bid >> 1 : bid - both;
  if (is_zero) {
    // A zero block: splats [z0, z1) that start at or past `total`.
    const int z0 = index * kZero;
    const int z1 = min(z0 + kZero, n);
    if (z0 >= n || offsets[z1 - 1] < total) return;
    const bool all = offsets[z0] >= total;
    for (int w = z0 + tid; w < z1; w += kThreads) {
      if (all || offsets[w] >= total) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) out[r * N + w] = 0.0f;
      }
    }
    return;
  }

  const int b = index;
  const int s0 = b * kSpan;
  if (s0 >= total) return;
  const int e = min(s0 + kSpan, total);
  // Stage the span's rows, from s0 (a multiple of kSpan, so every copy is
  // aligned) to e rounded up to a copy's width (inside the pool); they
  // arrive while the block searches.
  {
    constexpr int kGroups = kSpan / kVec;  // copies a row
    const int groups = (e - s0 + kVec - 1) / kVec;
    for (int i = tid; i < kRows * kGroups; i += kThreads) {
      const int r = i / kGroups;
      const int g = i % kGroups;
      if (g < groups) {
        cp_async<4 * kVec>(&s_rows[r][g * kVec],
                           rows + r * P + s0 + g * kVec);
      }
    }
    cp_async_commit();
  }
  // The splats that start in [s0, e): [first[0], first[1]).
  const int below[2] = {s0 - 1, e - 1};
  int first[2];
  block_first_above(offsets, n, below, first);
  // The splat that enters the span from an earlier one.
  const int wc = first[0] > 0 && cum[first[0] - 1] > s0 ? first[0] - 1 : -1;
  if (tid == 0) {
    cross[b] = wc;
    s_nlong = 0;
  }
  cp_async_wait_all();
  __syncthreads();

  const int w_begin = wc >= 0 ? wc : first[0];
  for (int c0 = w_begin; c0 < first[1]; c0 += kThreads) {
    const int w = c0 + tid;
    int a = 0, z = 0, lo = 0, hi = 0;
    if (w < first[1]) {
      lo = offsets[w];
      hi = min(cum[w], total);
      a = max(lo, s0) - s0;
      z = max(min(hi, e) - s0, a);
    }
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    bool is_long = false;
    int q = 0;
    if (z - a > kLong) {
      is_long = true;
      q = atomicAdd(&s_nlong, 1);
      s_long_lo[q] = a;
      s_long_hi[q] = z;
    } else {
      for (int s = a; s < z; ++s) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += s_rows[r][s];
      }
    }
    const int n_long = __syncthreads_count(is_long);
    if (n_long > 0) {  // block-uniform
      for (int l = warp; l < n_long; l += kWarps) {
        const int la = s_long_lo[l], lz = s_long_hi[l];
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = 0.0f;
        for (int s = la + lane; s < lz; s += 32) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] += s_rows[r][s];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            v[r] += __shfl_xor_sync(kFull, v[r], o);
          }
          if (lane == 0) s_part[l][r] = v[r];
        }
      }
      __syncthreads();
      if (is_long) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = s_part[q][r];
      }
      __syncthreads();  // s_part and the long list are free again
      if (tid == 0) s_nlong = 0;
    }
    if (w < first[1]) {
      float* dst;
      size_t stride;
      if (lo < s0) {         // entered from an earlier span
        dst = head + static_cast<size_t>(b) * kRows;
        stride = 1;
      } else if (hi > e) {   // goes on into a later span
        dst = tail + static_cast<size_t>(b) * kRows;
        stride = 1;
      } else {
        dst = out + w;
        stride = N;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) dst[r * stride] = acc[r];
    }
    __syncthreads();  // s_nlong is 0 before the next chunk's atomics
  }
}

// The splat kernel: a block a run of kThreads splats, their
// slots streamed through shared memory chunk after chunk. kVec: floats a
// copy (4 when every row of the pool is 16-byte aligned).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
segsum_splat_kernel(const float* __restrict__ rows, int pool,
                    const int* __restrict__ offsets,
                    const int* __restrict__ cum,
                    const int* __restrict__ total_p, int n,
                    float* __restrict__ out) {
  __shared__ __align__(16) float s_rows[2][kRows][kChunk];
  __shared__ float s_part[kChunkLong][kWarps][kRows];
  __shared__ int s_long_lo[kChunkLong], s_long_hi[kChunkLong];
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

// A thread a span block: where the splat that entered span b ends in it,
// its sum is its first span's tail plus the heads of the spans after it,
// up to b, in span order.
__global__ void __launch_bounds__(kJoinThreads)
segsum_join_kernel(int pool, const int* __restrict__ offsets,
                   const int* __restrict__ cum,
                   const int* __restrict__ total_p, int n, int span_blocks,
                   float* __restrict__ out, const float* __restrict__ head,
                   const float* __restrict__ tail,
                   const int* __restrict__ cross) {
  const int b = blockIdx.x * kJoinThreads + threadIdx.x;
  if (b >= span_blocks) return;
  const int total = min(*total_p, pool);
  const int s0 = b * kSpan;
  if (s0 >= total) return;
  const int w = cross[b];
  if (w < 0 || min(cum[w], total) > min(s0 + kSpan, total)) return;
  const int b0 = offsets[w] / kSpan;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = tail[b0 * kRows + r];
  for (int k = b0 + 1; k <= b; ++k) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += head[k * kRows + r];
  }
  const size_t N = static_cast<size_t>(n);
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * N + w] = acc[r];
}

int span_blocks_of(int pool) { return (pool + kSpan - 1) / kSpan; }

}  // namespace

// Floats of scratch segsum_launch needs for a pool: head and tail rows
// and the cross ids (as ints) of every span block.
extern "C" long long segsum_scratch_floats(int pool) {
  return static_cast<long long>(span_blocks_of(pool)) * (2 * kRows + 1);
}

extern "C" int segsum_launch(const float* rows, int pool, const int* offsets,
                             const int* cum, const int* total, int n,
                             float* out, float* scratch, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      pool % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (n >= kSplatMinSplats) {
    const int blocks = (n + kThreads - 1) / kThreads;
    if (aligned) {
      segsum_splat_kernel<4><<<blocks, kThreads, 0, s>>>(
          rows, pool, offsets, cum, total, n, out);
    } else {
      segsum_splat_kernel<1><<<blocks, kThreads, 0, s>>>(
          rows, pool, offsets, cum, total, n, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int spans = span_blocks_of(pool);
  const int zeros = (n + kZero - 1) / kZero;
  float* head = scratch;
  float* tail = scratch + static_cast<size_t>(spans) * kRows;
  int* cross = reinterpret_cast<int*>(scratch +
                                      static_cast<size_t>(spans) * 2 * kRows);
  if (aligned) {
    segsum_span_kernel<4><<<spans + zeros, kThreads, 0, s>>>(
        rows, pool, offsets, cum, total, n, spans, out, head, tail, cross);
  } else {
    segsum_span_kernel<1><<<spans + zeros, kThreads, 0, s>>>(
        rows, pool, offsets, cum, total, n, spans, out, head, tail, cross);
  }
  if (spans > 0) {
    segsum_join_kernel<<<(spans + kJoinThreads - 1) / kJoinThreads,
                         kJoinThreads, 0, s>>>(pool, offsets, cum, total, n,
                                               spans, out, head, tail, cross);
  }
  return static_cast<int>(cudaGetLastError());
}
