// The exact tile pretest (sm_90a): each splat's ellipse-vs-box test over
// its raster-cell bbox on the fixed 8x8 layout.
//
// Replaces no TPU kernel: brush_tpu/ops/binning.py:precompute_tile_masks
// (:186) is plain XLA, which fuses its dense (64, N) pass on the TPU. Its
// port in plain PyTorch (ops/binning.precompute_tile_masks_plain, the CPU
// path and this kernel's twin) issues about sixty elementwise kernels over
// (8, N), (8, 8, N) and (64, N) tensors: at 5.24M splats an (8, 8, N)
// float tensor is 1.34 GB, and the stage took 50.5 ms of the bicycle
// training step's 150, nearly all of it traffic on intermediates.
//
// What it computes, per splat i with raster cells of (gw, gh) tiles (wpx =
// 16 gw, hpx = 16 gh pixels): the cell bbox [cmin, cmax) from the tile
// bbox (floor divisions), w = cmax_x - cmin_x, h = cmax_y - cmin_y, area =
// w h if visible else 0, small = w <= 8 && h <= 8 && area > 0; with sig =
// log(255 opac) and the conic scaled by 1 / (2 sig), bit ky * 8 + kx of the
// 64-bit mask is the sign-test form of the ellipse-vs-box test (see
// ops/binning._edge_hits) against cell (cmin_x + kx, cmin_y + ky), for kx <
// w and ky < h, where sig > 0 and area > 0 (zero elsewhere). Outputs:
// mask_lo, mask_hi (u32 halves in int64), pc_pack (byte j's popcount at
// bits 4j..4j+3), counts = small ? popcount : area (int64), small (bool).
//
// Bound on the H100: bytes. 41 read a splat (xy, conic, opacity, the tile
// bbox, visible) and 33 written (four int64 words and a bool): 0.39 GB at
// 5.24M splats, 0.116 ms at 3.35 TB/s. The tests are at most 64 of about
// 30 float operations a splat, and on the bicycle scene a bbox is mostly
// 1x1 to 2x2 cells, a few tests a splat.
//
// Design: one thread a splat, grid-stride; the loads and the stores of a
// warp are each contiguous. The plain twin's (8, N) column pieces (dx_c, px,
// gx1, axm1, pxb, e1a, e1b, rx) live in registers for kx < min(w, 8), the
// row pieces (dy_c, py, gy1, ay, e2a, e2b, ry) are made once a row for ky <
// min(h, 8), and only the (kx, ky) tests inside that window run: the plain
// twin's tests outside it are masked to zero, so nothing is skipped but
// provably false bits. The loops are unrolled with guards, so the column
// arrays are indexed by constants and stay in registers.
//
// Numerics: bit-equal to the plain twin on the card. Every product, sum and
// difference is the twin's, term by term and in its order, through
// __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
// FMA (PyTorch's elementwise kernels round each op). sig is the precise
// logf and 1 / (2 sig) an IEEE division, as PyTorch's CUDA log and
// reciprocal compute them; sign() is torch.sign's, 0 at zero and at NaN, so
// NaN conics fail every test as the twin's comparisons do, and a splat
// with sig <= 0 (or NaN) or area <= 0 gets no bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWidth = 16;   // constants.TILE_WIDTH
constexpr int kSide = 8;         // the fixed layout's columns and rows
constexpr int kBlocksPerSm = 8;  // grid-stride cap, in blocks an SM

// a / b rounded toward minus infinity (torch.div's "floor") for b >= 1;
// no division at b == 1 (the tile path).
__device__ __forceinline__ long long floor_div(long long a, int b) {
  if (b == 1) return a;
  const long long q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}

// torch.sign: 1 above zero, -1 below, 0 at zero and at NaN.
__device__ __forceinline__ float sign_of(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

// One edge's vertex test: hb^2 >= a c, hb <= 0, hb + a >= 0, a > 0.
__device__ __forceinline__ bool vertex(float a, float hb, float c) {
  return (__fmul_rn(hb, hb) >= __fmul_rn(a, c)) && (hb <= 0.0f) &&
         (__fadd_rn(hb, a) >= 0.0f) && (a > 0.0f);
}

// The far end of one edge: a + 2 hb + c <= 0.
__device__ __forceinline__ bool far_end(float a, float hb, float c) {
  return __fadd_rn(__fadd_rn(a, __fmul_rn(2.0f, hb)), c) <= 0.0f;
}

__global__ void __launch_bounds__(kThreads) tile_pretest_kernel(
    const float* __restrict__ xy, const float* __restrict__ conic,
    const float* __restrict__ opac, const int* __restrict__ tile_min,
    const int* __restrict__ tile_max,
    const unsigned char* __restrict__ visible, int n, int gw, int gh,
    long long* __restrict__ counts, long long* __restrict__ mask_lo,
    long long* __restrict__ mask_hi, long long* __restrict__ pc_pack,
    bool* __restrict__ small) {
  const float wpx = static_cast<float>(kTileWidth * gw);
  const float hpx = static_cast<float>(kTileWidth * gh);
  const float ext_x = wpx / 2.0f;   // exact: a power of two times 8
  const float ext_y = hpx / 2.0f;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const size_t i2 = 2 * static_cast<size_t>(i);
    const size_t i3 = 3 * static_cast<size_t>(i);
    const long long cmin_x = floor_div(tile_min[i2], gw);
    const long long cmin_y = floor_div(tile_min[i2 + 1], gh);
    const long long cmax_x = floor_div(
        static_cast<long long>(tile_max[i2]) + (gw - 1), gw);
    const long long cmax_y = floor_div(
        static_cast<long long>(tile_max[i2 + 1]) + (gh - 1), gh);
    const long long bbox_w = cmax_x - cmin_x;
    const long long bbox_h = cmax_y - cmin_y;
    const long long area = visible[i] ? bbox_w * bbox_h : 0;
    const bool is_small = bbox_w <= kSide && bbox_h <= kSide && area > 0;
    const float sig = logf(__fmul_rn(opac[i], 255.0f));

    unsigned long long m = 0;
    if (sig > 0.0f && area > 0) {
      const float scale = __fdiv_rn(1.0f, __fmul_rn(2.0f, sig));
      const float ca = __fmul_rn(conic[i3], scale);
      const float cb = __fmul_rn(conic[i3 + 1], scale);
      const float cc = __fmul_rn(conic[i3 + 2], scale);
      const float cb2 = __fmul_rn(2.0f, cb);
      const float a1 = __fmul_rn(ca, wpx * wpx);   // wpx^2 exact
      const float a2 = __fmul_rn(cc, hpx * hpx);
      const int nx = bbox_w < kSide ? static_cast<int>(bbox_w) : kSide;
      const int ny = bbox_h < kSide ? static_cast<int>(bbox_h) : kSide;

      // Column pieces, kx < nx.
      const float x0 = __fsub_rn(
          __fsub_rn(xy[i2], __fmul_rn(static_cast<float>(cmin_x), wpx)),
          ext_x);
      float px[kSide], axm1[kSide], pxb[kSide], e1a[kSide], e1b[kSide];
      bool rx[kSide];
#pragma unroll
      for (int k = 0; k < kSide; ++k) {
        if (k < nx) {
          const float d = __fsub_rn(x0, __fmul_rn(static_cast<float>(k), wpx));
          const float s = sign_of(d);
          rx[k] = fabsf(d) <= ext_x;
          px[k] = __fsub_rn(__fmul_rn(s, ext_x), d);
          const float gx1 = __fmul_rn(ca, px[k]);
          axm1[k] = __fsub_rn(__fmul_rn(gx1, px[k]), 1.0f);
          pxb[k] = __fmul_rn(cb2, px[k]);
          const float e1k = __fmul_rn(-s, wpx);
          e1a[k] = __fmul_rn(e1k, gx1);
          e1b[k] = __fmul_rn(e1k, cb);
        }
      }

      // Rows, ky < ny, each made once and combined with every column.
      const float y0 = __fsub_rn(
          __fsub_rn(xy[i2 + 1], __fmul_rn(static_cast<float>(cmin_y), hpx)),
          ext_y);
#pragma unroll
      for (int ky = 0; ky < kSide; ++ky) {
        if (ky < ny) {
          const float d = __fsub_rn(y0, __fmul_rn(static_cast<float>(ky), hpx));
          const float s = sign_of(d);
          const bool ry = fabsf(d) <= ext_y;
          const float py = __fsub_rn(__fmul_rn(s, ext_y), d);
          const float gy1 = __fmul_rn(cc, py);
          const float ay = __fmul_rn(gy1, py);
          const float e2k = __fmul_rn(-s, hpx);
          const float e2a = __fmul_rn(e2k, gy1);
          const float e2b = __fmul_rn(e2k, cb);
#pragma unroll
          for (int kx = 0; kx < kSide; ++kx) {
            if (kx < nx) {
              const float c = __fadd_rn(__fadd_rn(axm1[kx], ay),
                                        __fmul_rn(pxb[kx], py));
              const float hb1 = __fadd_rn(e1a[kx], __fmul_rn(e1b[kx], py));
              const float hb2 = __fadd_rn(e2a, __fmul_rn(e2b, px[kx]));
              const bool hit = (rx[kx] && ry) || c <= 0.0f ||
                               far_end(a1, hb1, c) || vertex(a1, hb1, c) ||
                               far_end(a2, hb2, c) || vertex(a2, hb2, c);
              if (hit) m |= 1ull << (ky * kSide + kx);
            }
          }
        }
      }
    }

    long long pc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pc |= static_cast<long long>(
                __popcll((m >> (8 * j)) & 0xFFull)) << (4 * j);
    }
    counts[i] = is_small ? static_cast<long long>(__popcll(m)) : area;
    mask_lo[i] = static_cast<long long>(m & 0xFFFFFFFFull);
    mask_hi[i] = static_cast<long long>(m >> 32);
    pc_pack[i] = pc;
    small[i] = is_small;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError(). n may be 0.
extern "C" int tile_pretest_launch(const float* xy, const float* conic,
                                   const float* opac, const int* tile_min,
                                   const int* tile_max,
                                   const unsigned char* visible, int n,
                                   int gw, int gh, long long* counts,
                                   long long* mask_lo, long long* mask_hi,
                                   long long* pc_pack, bool* small,
                                   void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int need = (n + kThreads - 1) / kThreads;
  const int cap = (sms > 0 ? sms : 1) * kBlocksPerSm;
  const int blocks = need < cap ? need : cap;
  tile_pretest_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      xy, conic, opac, tile_min, tile_max, visible, n, gw, gh, counts,
      mask_lo, mask_hi, pc_pack, small);
  return static_cast<int>(cudaGetLastError());
}
