// The order in which the tile rasterizers' blocks take their tiles, shared
// by rasterize_fwd.cu and rasterize_bwd.cu (the build hashes every header
// into each library's name, so an edit here rebuilds both).
//
// A tile's sweep over its records is serial, so a kernel's time is the time
// of the SM that draws the most records. Launched in index order, all heavy
// tiles of a scene start at once wherever the scheduler puts them, some SMs
// draw twice their share and the rest go idle early. With most records
// first the heavy tiles spread over the SMs round-robin and the light ones
// fill in behind them as SMs come free.
//
// tile_order_kernel (one block) writes order[0 .. num_tiles): the tiles in
// buckets of a half power of two in the record count, heaviest bucket
// first. The order inside a bucket is left to the integer atomics, since no
// result depends on it: block b of a rasterizer sweeps tile order[b] and
// every tile is swept exactly once.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kOrderThreads = 1024;
constexpr int kBuckets = 64;

__device__ __forceinline__ int order_bucket(int count) {
  if (count <= 0) return kBuckets - 1;
  const int lg = 31 - __clz(count);
  const int half = lg > 0 ? (count >> (lg - 1)) & 1 : 0;
  return max(0, kBuckets - 2 - (2 * lg + half));
}

__global__ void __launch_bounds__(kOrderThreads)
tile_order_kernel(const int* __restrict__ starts,
                  const int* __restrict__ ends, int num_tiles,
                  int* __restrict__ order) {
  __shared__ int s_base[kBuckets];
  const int tid = threadIdx.x;
  if (tid < kBuckets) s_base[tid] = 0;
  __syncthreads();
  for (int t = tid; t < num_tiles; t += kOrderThreads) {
    atomicAdd(&s_base[order_bucket(ends[t] - starts[t])], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      const int c = s_base[b];
      s_base[b] = sum;
      sum += c;
    }
  }
  __syncthreads();
  for (int t = tid; t < num_tiles; t += kOrderThreads) {
    order[atomicAdd(&s_base[order_bucket(ends[t] - starts[t])], 1)] = t;
  }
}

}  // namespace
