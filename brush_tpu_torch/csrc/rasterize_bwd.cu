// Backward tile rasterizer: per-record gradient rows in tile order (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/rasterize_bwd.py, rasterize_bwd_pallas
// (:414) and its body _make_bwd_kernel (:56, per-batch math :199-346) —
// the TPU kernel rebuilds log T with an MXU prefix scan over 512-record
// batches and sums each record's terms over the tile's pixels as moment
// matmuls on the MXU (v_sigma against [1, px, py, px^2, py^2, px py]).
//
// What it computes, per 16x16 tile t and pixel i (centre
// (tx*16 + i%16 + 0.5, ty*16 + i/16 + 0.5)), sweeping the tile's records
// back to front from min(end, max_i final_idx + 1) - 1 down to start, with
// lt = log_t (the forward's), t_final = exp(lt), s_behind = 0:
//   sigma, vis = exp(-max(sigma, 0)), alpha = min(ALPHA_MAX, o vis), as in
//   the forward; the record is active iff j <= final_idx, sigma >= 0 and
//   alpha >= ALPHA_EPS. Then
//   m = log1p(-alpha), t_before = exp(lt - m), fac = alpha t_before,
//   cw = c . v_rgb,
//   v_alpha = cw t_before - s_behind / (1 - alpha) + t_final v_a / (1 - alpha)
//   s_behind += cw fac, lt -= m, vs = -o vis v_alpha, d = xy - pixel;
//   terms: vs (cxx dx + cxy dy), vs (cxy dx + cyy dy), vs dx^2 / 2,
//   vs dx dy, vs dy^2 / 2, fac v_rgb (3), vis v_alpha.
// The ALPHA_MAX clamp is ignored in the sigma and opacity terms, as in the
// TPU kernel (rasterize_bwd.py:228-304). Each term is summed over the
// tile's 256 pixels and written to grads[row * pool + j]; slots no sweep
// reaches keep the zeros the wrapper allocated.
//
// Bound on the H100: operations. Every (pixel, record) pair of the sweep
// costs the forward's ~20 float32 operations for sigma and alpha, and each
// active pair ~40 more (log1p, two exps, a division, the nine terms) plus
// the nine-term pixel reduction; records are 28 bytes read and 36 written.
//
// Design: one 256-thread block per tile, one thread per pixel, the
// counterpart of rasterize_fwd.cu. Records are staged back to front through
// shared memory in batches of 256, decoded once per block. Each record's
// nine terms are summed over a warp with xor shuffles (skipped when no lane
// of the warp is active), the 8 warps' partials land in shared memory, and
// after every 128 records each thread sums (row, record) pairs over the 8
// warps in a fixed order and writes them coalesced. No atomics: each record
// belongs to one tile, so the result is deterministic. Sigma and the colour
// decode use the forward's explicitly rounded intrinsics, so the active set
// is the forward's and matches the PyTorch version's.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 256;  // records staged per batch
constexpr int kSub = 128;    // records per shared-memory partials pass
constexpr int kRows = 9;
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaEps = static_cast<float>(1.0 / 255.0);
constexpr float kColorLo = -4.0f;
constexpr float kColorStep = static_cast<float>(1.0 / (65535.0 / 8.0));
constexpr float kOpacStep = static_cast<float>(1.0 / 65535.0);

__device__ __forceinline__ float decode_color(unsigned q) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), kColorStep), kColorLo);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kPixels)
rasterize_bwd_kernel(const int* __restrict__ packed, int pool,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int tiles_x,
                     const float* __restrict__ v_out,
                     const float* __restrict__ log_t_in,
                     const int* __restrict__ fidx_in,
                     float* __restrict__ grads) {
  __shared__ float s_x[kBatch], s_y[kBatch], s_cxx[kBatch], s_cxy[kBatch],
      s_cyy[kBatch], s_r[kBatch], s_g[kBatch], s_b[kBatch], s_o[kBatch];
  __shared__ float s_part[kWarps][kRows][kSub];
  __shared__ int s_last;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const size_t P = static_cast<size_t>(pool);
  const size_t p = static_cast<size_t>(t) * kPixels + i;
  const int start = starts[t];
  const int end = ends[t];
  const int fidx = fidx_in[p];

  // One past the last record any pixel of the tile composited.
  if (i == 0) s_last = -1;
  __syncthreads();
  atomicMax(&s_last, fidx);
  __syncthreads();
  const int last = min(end, s_last + 1);
  if (last <= start) return;  // uniform: empty tile or nothing composited

  const float px = static_cast<float>((t % tiles_x) * kTile + (i % kTile)) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * kTile + (i / kTile)) + 0.5f;
  const float vr = v_out[p * 4 + 0];
  const float vg = v_out[p * 4 + 1];
  const float vb = v_out[p * 4 + 2];
  const float va = v_out[p * 4 + 3];
  float lt = log_t_in[p];
  const float t_final = expf(lt);
  float s_behind = 0.0f;

  for (int b_end = last; b_end > start; b_end -= kBatch) {
    const int b_start = max(start, b_end - kBatch);
    const int count = b_end - b_start;
    __syncthreads();  // the previous batch's readers are done
    if (i < count) {
      const int j = b_start + i;
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

    for (int s_end = count; s_end > 0; s_end -= kSub) {
      const int s_start = max(0, s_end - kSub);
      for (int k = s_end - 1; k >= s_start; --k) {
        const int j = b_start + k;
        const float dx = __fsub_rn(s_x[k], px);
        const float dy = __fsub_rn(s_y[k], py);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s_cxx[k], dx), dx),
                                     __fmul_rn(__fmul_rn(s_cyy[k], dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(s_cxy[k], dx), dy));
        const float vis = expf(-fmaxf(sigma, 0.0f));
        const float o = s_o[k];
        const float alpha = fminf(kAlphaMax, __fmul_rn(o, vis));
        const bool act = j <= fidx && sigma >= 0.0f && alpha >= kAlphaEps;

        float g[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) g[r] = 0.0f;
        if (act) {
          const float m = log1pf(-alpha);
          const float t_before = expf(lt - m);
          const float fac = alpha * t_before;
          const float cw = s_r[k] * vr + s_g[k] * vg + s_b[k] * vb;
          const float ra = 1.0f / (1.0f - alpha);
          const float v_alpha =
              cw * t_before - s_behind * ra + t_final * ra * va;
          s_behind += cw * fac;
          lt -= m;
          const float vs = -o * vis * v_alpha;
          g[0] = vs * (s_cxx[k] * dx + s_cxy[k] * dy);
          g[1] = vs * (s_cxy[k] * dx + s_cyy[k] * dy);
          g[2] = 0.5f * vs * dx * dx;
          g[3] = vs * dx * dy;
          g[4] = 0.5f * vs * dy * dy;
          g[5] = fac * vr;
          g[6] = fac * vg;
          g[7] = fac * vb;
          g[8] = vis * v_alpha;
        }
        const int slot = k - s_start;
        if (__any_sync(kFull, act)) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float v = warp_sum(g[r]);
            if (lane == 0) s_part[warp][r][slot] = v;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) s_part[warp][r][slot] = 0.0f;
        }
      }
      __syncthreads();
      // Sum the 8 warps' partials of every (row, record) in a fixed order.
      const int n_sub = s_end - s_start;
      for (int q = i; q < kRows * n_sub; q += kPixels) {
        const int r = q / n_sub;
        const int k = q - r * n_sub;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += s_part[w][r][k];
        grads[r * P + static_cast<size_t>(b_start + s_start + k)] = acc;
      }
      __syncthreads();  // s_part is rewritten by the next pass
    }
  }
}

}  // namespace

extern "C" int rasterize_bwd_launch(const int* packed, int pool,
                                    const int* starts, const int* ends,
                                    int num_tiles, int tiles_x,
                                    const float* v_out, const float* log_t,
                                    const int* fidx, float* grads,
                                    void* stream) {
  if (num_tiles <= 0) return 0;
  rasterize_bwd_kernel<<<num_tiles, kPixels, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      packed, pool, starts, ends, tiles_x, v_out, log_t, fidx, grads);
  return static_cast<int>(cudaGetLastError());
}
