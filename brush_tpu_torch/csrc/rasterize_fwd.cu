// Forward tile rasterizer over the packed record pool (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/rasterize_fwd.py, rasterize_fwd_pallas
// (:500) and its body _make_kernel (:264) — the TPU kernel evaluates
// sigma as a rank-6 polynomial on the MXU and the transmittance as an MXU
// prefix scan over 512-record batches.
//
// What it computes, per 16x16 tile t and pixel i (centre
// (tx*16 + i%16 + 0.5, ty*16 + i/16 + 0.5)), over the tile's records
// [starts[t], ends[t]) in depth order:
//   sigma = 0.5 (cxx dx^2 + cyy dy^2) + cxy dx dy,  d = record xy - pixel
//   alpha = min(ALPHA_MAX, o exp(-max(sigma, 0)))
//   the record counts if sigma >= 0 and alpha >= ALPHA_EPS; then
//   log_t_after = log_t + log1p(-alpha); if log_t_after <= log(1e-4) the
//   pixel stops for good (the crossing record is not composited, the
//   reference's sticky `done`); else rgb += alpha exp(log_t) c,
//   log_t = log_t_after, final_idx = the record's pool index.
// Outputs: img (T, 256, 4) = (rgb, 1 - exp(log_t)), log_t (T, 256),
// final_idx (T, 256) (-1 where nothing contributed).
//
// Bound on the H100: operations. Every (pixel, record) pair a pixel reaches
// costs ~20 float32 operations including one exp; the records themselves
// are 28 bytes each, read once per tile.
//
// Design: one 256-thread block per tile, one thread per pixel, the way
// rasterize.wgsl does it. Records are staged through shared memory 256 at
// a time (decoded once per block, not once per pixel), every thread walks
// the batch sequentially, and the block stops once __syncthreads_count
// finds no live pixel. The sigma and colour decode arithmetic uses
// explicitly rounded intrinsics (no fused multiply-add) so each value is
// the one the PyTorch version computes op by op.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = kPixels;

constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaEps = static_cast<float>(1.0 / 255.0);
constexpr float kLogTEps = static_cast<float>(-9.210340371976182);  // log(1e-4)
constexpr float kColorLo = -4.0f;
constexpr float kColorStep = static_cast<float>(1.0 / (65535.0 / 8.0));
constexpr float kOpacStep = static_cast<float>(1.0 / 65535.0);

__device__ __forceinline__ float decode_color(unsigned q) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), kColorStep), kColorLo);
}

__global__ void __launch_bounds__(kPixels)
rasterize_fwd_kernel(const int* __restrict__ packed, int pool,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int tiles_x,
                     float* __restrict__ img, float* __restrict__ log_t_out,
                     int* __restrict__ fidx_out) {
  __shared__ float s_x[kBatch], s_y[kBatch], s_cxx[kBatch], s_cxy[kBatch],
      s_cyy[kBatch], s_r[kBatch], s_g[kBatch], s_b[kBatch], s_o[kBatch];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const size_t P = static_cast<size_t>(pool);
  const float px = static_cast<float>((t % tiles_x) * kTile + (i % kTile)) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * kTile + (i / kTile)) + 0.5f;
  const int start = starts[t];
  const int end = ends[t];

  float log_t = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int fidx = -1;
  bool alive = true;

  for (int base = start; base < end; base += kBatch) {
    if (__syncthreads_count(alive) == 0) break;
    const int j = base + i;
    if (j < end) {
      s_x[i] = __int_as_float(packed[0 * P + j]);
      s_y[i] = __int_as_float(packed[1 * P + j]);
      s_cxx[i] = __int_as_float(packed[2 * P + j]);
      s_cxy[i] = __int_as_float(packed[3 * P + j]);
      s_cyy[i] = __int_as_float(packed[4 * P + j]);
      const unsigned c0 = static_cast<unsigned>(packed[5 * P + j]);
      const unsigned c1 = static_cast<unsigned>(packed[6 * P + j]);
      s_r[i] = decode_color(c0 & 0xFFFFu);
      s_g[i] = decode_color(c0 >> 16);
      s_b[i] = decode_color(c1 & 0xFFFFu);
      s_o[i] = __fmul_rn(static_cast<float>(c1 >> 16), kOpacStep);
    }
    __syncthreads();
    const int count = min(kBatch, end - base);
    for (int k = 0; alive && k < count; ++k) {
      const float dx = __fsub_rn(s_x[k], px);
      const float dy = __fsub_rn(s_y[k], py);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s_cxx[k], dx), dx),
                                   __fmul_rn(__fmul_rn(s_cyy[k], dy), dy));
      const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                    __fmul_rn(__fmul_rn(s_cxy[k], dx), dy));
      const float vis = expf(-fmaxf(sigma, 0.0f));
      const float alpha = fminf(kAlphaMax, __fmul_rn(s_o[k], vis));
      if (!(sigma >= 0.0f && alpha >= kAlphaEps)) continue;
      const float after = __fadd_rn(log_t, log1pf(-alpha));
      if (after <= kLogTEps) {
        alive = false;
        break;
      }
      const float fac = __fmul_rn(alpha, expf(log_t));
      r = __fadd_rn(r, __fmul_rn(fac, s_r[k]));
      g = __fadd_rn(g, __fmul_rn(fac, s_g[k]));
      b = __fadd_rn(b, __fmul_rn(fac, s_b[k]));
      log_t = after;
      fidx = base + k;
    }
    __syncthreads();  // the next batch overwrites shared memory
  }

  const size_t p = static_cast<size_t>(t) * kPixels + i;
  img[p * 4 + 0] = r;
  img[p * 4 + 1] = g;
  img[p * 4 + 2] = b;
  img[p * 4 + 3] = 1.0f - expf(log_t);
  log_t_out[p] = log_t;
  fidx_out[p] = fidx;
}

}  // namespace

extern "C" int rasterize_fwd_launch(const int* packed, int pool,
                                    const int* starts, const int* ends,
                                    int num_tiles, int tiles_x, float* img,
                                    float* log_t, int* fidx, void* stream) {
  if (num_tiles <= 0) return 0;
  rasterize_fwd_kernel<<<num_tiles, kPixels, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      packed, pool, starts, ends, tiles_x, img, log_t, fidx);
  return static_cast<int>(cudaGetLastError());
}
