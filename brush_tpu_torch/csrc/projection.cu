// The projection of every splat and its backward (sm_90a): the
// quaternion's normalisation, world to view, near-plane culling, the
// scales' exp, the EWA 2D covariance with COV_BLUR, the det test, the
// conic, the radius and the tile bbox; backward, the gradients of the
// means, the log scales and the raw quaternions from those of xy and the
// conic.
//
// Replaces no TPU kernel: brush_tpu/ops/projection.py is plain XLA, which
// fuses the chain on the TPU. Its port in plain PyTorch
// (ops/projection.normalize_quats + project_splats, the CPU path and this
// forward's twin) dispatches about 270 elementwise passes forward and,
// under autograd, about 430 backward, each over a whole (N,) column: 7.3
// and 12.5 ms of the 60 ms bicycle training step at 5,242,880 splats.
//
// What they compute, per splat n (ops/projection.project_splats on
// normalize_quats(quats)): the seven fields of Projection (xy, depth,
// conic, radius, tile_min, tile_max, visible); backward, given the
// gradients of xy (n, 2) and conic (n, 3), those of means (n, 3),
// log_scales (n, 3) and quats (n, 4), with autograd's masks:
//   - a row culled by the near plane or `active` (its z taken as 1) still
//     passes xy's gradient to its means, through z = 1, none to depth;
//   - a row culled there or by det == 0 gets no conic gradient;
//   - inside the frustum clamp, tx = z (px / z) passes its gradient to px;
//     outside, tx = z * bound passes it to z (clamp's mask, inclusive);
//   - a quaternion whose norm is under the 1e-12 clamp gets no gradient
//     through its norm.
// The backward saves nothing: it recomputes the forward from its inputs.
// Its own order of the chain rule (written out in
// ops/projection.project_bwd_plain, its twin) is not autograd's, which
// sums a value's uses in the graph's order: the twin is held to float64
// autograd in the CPU tests.
//
// Bound on the H100: bytes. The forward reads means, log_scales (12 B
// each) and quats (16 B), with `active` 1 B more, and writes xy 8, depth
// 4, conic 12, radius 4, tile_min 8, tile_max 8 and visible 1: 40 (+1) B
// read and 45 written a splat. The backward reads the same 40 (+1) B and
// the gradients of xy and conic (20 B) and writes 40 B. At 5,242,880
// splats against 3.35 TB/s that is 0.133 + 0.157 ms, at 8,388,608 0.213 +
// 0.251. About 150 float operations a splat forward and 300 backward.
//
// Design: one thread a splat, kThreads = 128 a block. A block's rows of
// each (n, W) float input are one contiguous run of 128 W words; the block
// moves it through shared memory, neighbouring threads on neighbouring
// words, so a warp's global loads are contiguous whatever W, and each
// thread reads its own row there. The (n, W) outputs go back the same
// way; depth, radius and visible are one word a thread. Rows in shared
// memory lie at an odd stride (W | 1 words), so the threads of a warp,
// each at its own row, meet no bank conflict. The view matrix, focal and
// pixel centre are read from device memory by pointer (the host never
// reads them), the image size and tile counts are taken by value.
//
// Numerics: every product, sum, difference and quotient goes through
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __frcp_rn, which nvcc
// never contracts into an FMA (PyTorch's elementwise kernels round each
// operation), in the plain code's order; exp is the precise expf, sqrt
// __fsqrt_rn; clamps and maxima pass NaN as PyTorch's do; float -> int32
// saturates with NaN -> 0 as ops/projection._f32_to_i32. The constants are
// the plain code's Python floats rounded to float32, as PyTorch rounds a
// Python scalar operand. The quaternion's norm is sqrtf((w w + y y) +
// (x x + z z)) (ops/projection.quat_norm_plain), the order in which
// torch.linalg.vector_norm's CUDA reduction sums four squares (on an
// H100 80GB HBM3 the two agreed on every row of a 5,242,880-row draw,
// where (w w + x x) + (y y + z z) agreed on 86 %). So on the card the
// forward's seven outputs are project_splats(normalize_quats(quats))'s
// bit for bit, and the backward is its twin's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
// Blocks an SM must hold: nvcc then keeps the forward to 40 registers a
// thread and the backward to 64 (48 and 92 unasked, 10 and 5 blocks an
// SM). On an H100 80GB HBM3 (700 W), in turns with outputs bit-equal, the
// backward took 0.41-0.47 device ms at 5,242,880 rows against 0.57
// unasked (0.71 against 1.00 at 8,388,608), the forward 0.222 against
// 0.237 (0.362 against 0.393).
constexpr int kFwdBlocks = 12;
constexpr int kBwdBlocks = 8;

// A Python float's float32 value, as PyTorch rounds a scalar operand.
#define F32(v) static_cast<float>(v)

constexpr float kCovBlur = F32(0.3);       // constants.COV_BLUR
constexpr float kNearPlaneZ = F32(0.01);   // constants.NEAR_PLANE_Z
constexpr float kNormMin = F32(1e-12);     // normalize_quats' clamp
constexpr float kTileScale = 1.0f / 16.0f;   // 1 / constants.TILE_WIDTH
constexpr float kIntLimit = 1073741824.0f;   // 2^30, _f32_to_i32's bound

#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn
#define DIV __fdiv_rn

// torch.clamp(v, lo, hi) with tensor bounds: a NaN argument passes.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// torch.clamp(v, min=lo): NaN passes.
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.maximum: NaN passes.
__device__ __forceinline__ float maximum_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// ops/projection._f32_to_i32: NaN -> 0, saturating at +-2^30.
__device__ __forceinline__ int f32_to_i32(float v) {
  if (v != v) return 0;
  return static_cast<int>(fminf(fmaxf(v, -kIntLimit), kIntLimit));
}

// The camera's terms, the same in every thread: the world-to-view matrix
// (rows w, translation t), focal, pixel centre and calc_cov2d's frustum
// limits, each computed as the plain code computes its (2,) tensors.
struct Camera {
  float w[9], t[3], fx, fy, cx, cy, lo_x, hi_x, lo_y, hi_y;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ vm,
                                              const float* __restrict__ focal,
                                              const float* __restrict__ center,
                                              int img_w, int img_h) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.w[3 * i + j] = vm[4 * i + j];
    c.t[i] = vm[4 * i + 3];
  }
  c.fx = focal[0];
  c.fy = focal[1];
  c.cx = center[0];
  c.cy = center[1];
  const float iw = static_cast<float>(img_w);
  const float ih = static_cast<float>(img_h);
  // tan_fov = 0.5 img / focal; lims_pos = (img - center) / focal + 0.3
  // tan_fov; lims_neg = center / focal + 0.3 tan_fov.
  const float tan_x = DIV(MUL(0.5f, iw), c.fx);
  const float tan_y = DIV(MUL(0.5f, ih), c.fy);
  c.hi_x = ADD(DIV(SUB(iw, c.cx), c.fx), MUL(F32(0.3), tan_x));
  c.hi_y = ADD(DIV(SUB(ih, c.cy), c.fy), MUL(F32(0.3), tan_y));
  c.lo_x = -ADD(DIV(c.cx, c.fx), MUL(F32(0.3), tan_x));
  c.lo_y = -ADD(DIV(c.cy, c.fy), MUL(F32(0.3), tan_y));
  return c;
}

// One splat's forward terms, each as project_splats (and calc_cov2d,
// cov_to_conic) computes its column; the backward reads the ones it needs.
struct Terms {
  float norm, den, qw, qx, qy, qz;   // |q|, max(|q|, 1e-12), q / den
  float s[3];                        // exp(log_scales)
  float px, py, depth, z, rz, rz2;   // view space; z = depth or 1
  float vx, vy, vxc, vyc, tx, ty;    // p / z, clamped, times z
  float r[9];                        // R(q), row-major
  float m[9];                        // R diag(s)
  float t0[3], t1[3];                // T = J W, rows
  float u[3], q[3];                  // V t0, V t1
  float cov[3], det;                 // the 2D covariance + COV_BLUR
  float cs[3], inv;                  // the safe covariance, 1 / its det
  bool vis0, vis1;                   // culled: near plane, then det == 0
};

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return ADD(ADD(MUL(a0, b0), MUL(a1, b1)), MUL(a2, b2));
}

__device__ __forceinline__ Terms project_terms(const Camera& c,
                                               const float* mean,
                                               const float* log_scale,
                                               const float* quat,
                                               bool active) {
  Terms k;
  const float* w = c.w;
  // normalize_quats: q / clamp(|q|, min=1e-12).
  k.norm = __fsqrt_rn(ADD(ADD(MUL(quat[0], quat[0]), MUL(quat[2], quat[2])),
                          ADD(MUL(quat[1], quat[1]), MUL(quat[3], quat[3]))));
  k.den = clamp_min_nan(k.norm, kNormMin);
  k.qw = DIV(quat[0], k.den);
  k.qx = DIV(quat[1], k.den);
  k.qy = DIV(quat[2], k.den);
  k.qz = DIV(quat[3], k.den);
  // p = W m + t, left to right.
  k.px = ADD(dot3(mean[0], w[0], mean[1], w[1], mean[2], w[2]), c.t[0]);
  k.py = ADD(dot3(mean[0], w[3], mean[1], w[4], mean[2], w[5]), c.t[1]);
  k.depth = ADD(dot3(mean[0], w[6], mean[1], w[7], mean[2], w[8]), c.t[2]);
  k.vis0 = k.depth > kNearPlaneZ && active;
  k.z = k.vis0 ? k.depth : 1.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) k.s[j] = expf(log_scale[j]);
  // calc_cov2d.
  k.rz = __frcp_rn(k.z);
  k.rz2 = MUL(k.rz, k.rz);
  k.vx = MUL(k.px, k.rz);
  k.vy = MUL(k.py, k.rz);
  k.vxc = clamp_nan(k.vx, c.lo_x, c.hi_x);
  k.vyc = clamp_nan(k.vy, c.lo_y, c.hi_y);
  k.tx = MUL(k.z, k.vxc);
  k.ty = MUL(k.z, k.vyc);
  const float x2 = MUL(k.qx, k.qx), y2 = MUL(k.qy, k.qy),
              z2 = MUL(k.qz, k.qz);
  const float xy = MUL(k.qx, k.qy), xz = MUL(k.qx, k.qz),
              yz = MUL(k.qy, k.qz);
  const float wx = MUL(k.qw, k.qx), wy = MUL(k.qw, k.qy),
              wz = MUL(k.qw, k.qz);
  k.r[0] = SUB(1.0f, MUL(2.0f, ADD(y2, z2)));
  k.r[1] = MUL(2.0f, SUB(xy, wz));
  k.r[2] = MUL(2.0f, ADD(xz, wy));
  k.r[3] = MUL(2.0f, ADD(xy, wz));
  k.r[4] = SUB(1.0f, MUL(2.0f, ADD(x2, z2)));
  k.r[5] = MUL(2.0f, SUB(yz, wx));
  k.r[6] = MUL(2.0f, SUB(xz, wy));
  k.r[7] = MUL(2.0f, ADD(yz, wx));
  k.r[8] = SUB(1.0f, MUL(2.0f, ADD(x2, y2)));
#pragma unroll
  for (int i = 0; i < 9; ++i) k.m[i] = MUL(k.r[i], k.s[i % 3]);
  const float* m = k.m;
  // V = M M^T, its six entries.
  const float v00 = dot3(m[0], m[0], m[1], m[1], m[2], m[2]);
  const float v01 = dot3(m[0], m[3], m[1], m[4], m[2], m[5]);
  const float v02 = dot3(m[0], m[6], m[1], m[7], m[2], m[8]);
  const float v11 = dot3(m[3], m[3], m[4], m[4], m[5], m[5]);
  const float v12 = dot3(m[3], m[6], m[4], m[7], m[5], m[8]);
  const float v22 = dot3(m[6], m[6], m[7], m[7], m[8], m[8]);
  // J rows [fx rz, 0, -fx tx rz2], [0, fy rz, -fy ty rz2]; T = J W.
  const float ja = MUL(c.fx, k.rz);
  const float jc0 = MUL(MUL(-c.fx, k.tx), k.rz2);
  const float jb = MUL(c.fy, k.rz);
  const float jc1 = MUL(MUL(-c.fy, k.ty), k.rz2);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    k.t0[j] = ADD(MUL(ja, w[j]), MUL(jc0, w[6 + j]));
    k.t1[j] = ADD(MUL(jb, w[3 + j]), MUL(jc1, w[6 + j]));
  }
  // cov = T V T^T.
  k.u[0] = dot3(v00, k.t0[0], v01, k.t0[1], v02, k.t0[2]);
  k.u[1] = dot3(v01, k.t0[0], v11, k.t0[1], v12, k.t0[2]);
  k.u[2] = dot3(v02, k.t0[0], v12, k.t0[1], v22, k.t0[2]);
  const float c00 = dot3(k.t0[0], k.u[0], k.t0[1], k.u[1], k.t0[2], k.u[2]);
  const float c01 = dot3(k.t1[0], k.u[0], k.t1[1], k.u[1], k.t1[2], k.u[2]);
  k.q[0] = dot3(v00, k.t1[0], v01, k.t1[1], v02, k.t1[2]);
  k.q[1] = dot3(v01, k.t1[0], v11, k.t1[1], v12, k.t1[2]);
  k.q[2] = dot3(v02, k.t1[0], v12, k.t1[1], v22, k.t1[2]);
  const float c11 = dot3(k.t1[0], k.q[0], k.t1[1], k.q[1], k.t1[2], k.q[2]);
  k.cov[0] = ADD(c00, kCovBlur);
  k.cov[1] = c01;
  k.cov[2] = ADD(c11, kCovBlur);
  // project_splats: the det test, then cov_to_conic on the safe value.
  k.det = SUB(MUL(k.cov[0], k.cov[2]), MUL(k.cov[1], k.cov[1]));
  k.vis1 = k.vis0 && k.det != 0.0f;
  k.cs[0] = k.vis1 ? k.cov[0] : 1.0f;
  k.cs[1] = k.vis1 ? k.cov[1] : 0.0f;
  k.cs[2] = k.vis1 ? k.cov[2] : 1.0f;
  k.inv = __frcp_rn(SUB(MUL(k.cs[0], k.cs[2]), MUL(k.cs[1], k.cs[1])));
  return k;
}

// A block's rows [first, first + rows) of an (n, W) array of 32-bit
// words, moved between global memory (one contiguous run) and shared
// memory (row r at r * kStride); int32 rows travel as their bits.
template <int W>
struct Stage {
  static constexpr int kStride = W | 1;
  float* s;

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int first, int rows) {
    const float* run = src + static_cast<size_t>(first) * W;
    for (int u = threadIdx.x; u < rows * W; u += kThreads) {
      const int r = u / W;
      s[r * kStride + (u - r * W)] = run[u];
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ dst, int first,
                                        int rows) const {
    float* run = dst + static_cast<size_t>(first) * W;
    for (int u = threadIdx.x; u < rows * W; u += kThreads) {
      const int r = u / W;
      run[u] = s[r * kStride + (u - r * W)];
    }
  }
  __device__ __forceinline__ float* row(int r) const {
    return s + r * kStride;
  }
};

// Shared floats of a block: Stage strides of 3 (3), 2 (3) and 4 (5) wide
// rows.
constexpr int kFwdShared = kThreads * (3 + 3 + 5 + 3 + 3 + 3 + 3);
constexpr int kBwdShared = kThreads * (3 + 3 + 5 + 3 + 3 + 3 + 3 + 5);

__global__ void __launch_bounds__(kThreads, kFwdBlocks) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const uint8_t* __restrict__ active,
    const float* __restrict__ viewmat, const float* __restrict__ focal,
    const float* __restrict__ center, int img_w, int img_h, int tiles_x,
    int tiles_y, int n, float* __restrict__ xy, float* __restrict__ depth,
    float* __restrict__ conic, int* __restrict__ radius,
    int* __restrict__ tile_min, int* __restrict__ tile_max,
    uint8_t* __restrict__ visible) {
  __shared__ float smem[kFwdShared];
  Stage<3> s_mean{smem};
  Stage<3> s_scale{smem + kThreads * 3};
  Stage<4> s_quat{smem + kThreads * 6};
  Stage<2> s_xy{smem + kThreads * 11};
  Stage<3> s_conic{smem + kThreads * 14};
  Stage<2> s_tmin{smem + kThreads * 17};
  Stage<2> s_tmax{smem + kThreads * 20};
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - first);
  s_mean.load(means, first, rows);
  s_scale.load(log_scales, first, rows);
  s_quat.load(quats, first, rows);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const int i = first + t;
    const Camera c = load_camera(viewmat, focal, center, img_w, img_h);
    const Terms k = project_terms(c, s_mean.row(t), s_scale.row(t),
                                  s_quat.row(t),
                                  active == nullptr || active[i] != 0);
    const float cn0 = MUL(k.cs[2], k.inv);
    const float cn1 = MUL(-k.cs[1], k.inv);
    const float cn2 = MUL(k.cs[0], k.inv);
    const float x = ADD(MUL(DIV(k.px, k.z), c.fx), c.cx);
    const float y = ADD(MUL(DIV(k.py, k.z), c.fy), c.cy);
    // radius_from_conic, for rows still visible (0 for the others).
    int rad = 0;
    if (k.vis1) {
      const float d = __frcp_rn(SUB(MUL(cn0, cn2), MUL(cn1, cn1)));
      const float b = MUL(0.5f, ADD(MUL(cn2, d), MUL(cn0, d)));
      const float disc =
          __fsqrt_rn(clamp_min_nan(SUB(MUL(b, b), d), F32(0.1)));
      const float v = maximum_nan(ADD(b, disc), SUB(b, disc));
      rad = f32_to_i32(
          ceilf(MUL(3.0f, __fsqrt_rn(clamp_min_nan(v, 0.0f)))));
    }
    // tile_bbox.
    const float rt = MUL(static_cast<float>(rad), kTileScale);
    const float cx = MUL(x, kTileScale), cy = MUL(y, kTileScale);
    const float bx = static_cast<float>(tiles_x);
    const float by = static_cast<float>(tiles_y);
    const int x0 = f32_to_i32(clamp_nan(floorf(SUB(cx, rt)), 0.0f, bx));
    const int y0 = f32_to_i32(clamp_nan(floorf(SUB(cy, rt)), 0.0f, by));
    const int x1 =
        f32_to_i32(clamp_nan(floorf(ADD(ADD(cx, rt), 1.0f)), 0.0f, bx));
    const int y1 =
        f32_to_i32(clamp_nan(floorf(ADD(ADD(cy, rt), 1.0f)), 0.0f, by));
    float* o = s_xy.row(t);
    o[0] = x;
    o[1] = y;
    o = s_conic.row(t);
    o[0] = cn0;
    o[1] = cn1;
    o[2] = cn2;
    o = s_tmin.row(t);   // the tile bounds as their bits
    o[0] = __int_as_float(x0);
    o[1] = __int_as_float(y0);
    o = s_tmax.row(t);
    o[0] = __int_as_float(x1);
    o[1] = __int_as_float(y1);
    depth[i] = k.depth;
    radius[i] = rad;
    visible[i] = k.vis1 && x1 > x0 && y1 > y0;
  }
  __syncthreads();
  s_xy.store(xy, first, rows);
  s_conic.store(conic, first, rows);
  s_tmin.store(reinterpret_cast<float*>(tile_min), first, rows);
  s_tmax.store(reinterpret_cast<float*>(tile_max), first, rows);
}

__global__ void __launch_bounds__(kThreads, kBwdBlocks) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ log_scales,
    const float* __restrict__ quats, const uint8_t* __restrict__ active,
    const float* __restrict__ viewmat, const float* __restrict__ focal,
    const float* __restrict__ center, int img_w, int img_h, int n,
    const float* __restrict__ g_xy, const float* __restrict__ g_conic,
    float* __restrict__ g_means, float* __restrict__ g_log_scales,
    float* __restrict__ g_quats) {
  __shared__ float smem[kBwdShared];
  Stage<3> s_mean{smem};
  Stage<3> s_scale{smem + kThreads * 3};
  Stage<4> s_quat{smem + kThreads * 6};
  Stage<2> s_gxy{smem + kThreads * 11};
  Stage<3> s_gconic{smem + kThreads * 14};
  Stage<3> s_gmean{smem + kThreads * 17};
  Stage<3> s_gscale{smem + kThreads * 20};
  Stage<4> s_gquat{smem + kThreads * 23};
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - first);
  s_mean.load(means, first, rows);
  s_scale.load(log_scales, first, rows);
  s_quat.load(quats, first, rows);
  s_gxy.load(g_xy, first, rows);
  s_gconic.load(g_conic, first, rows);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < rows) {
    const int i = first + t;
    const Camera c = load_camera(viewmat, focal, center, img_w, img_h);
    const Terms k = project_terms(c, s_mean.row(t), s_scale.row(t),
                                  s_quat.row(t),
                                  active == nullptr || active[i] != 0);
    const float* w = c.w;
    const float gx = s_gxy.row(t)[0], gy = s_gxy.row(t)[1];
    const float ga = s_gconic.row(t)[0], gb = s_gconic.row(t)[1],
                gc = s_gconic.row(t)[2];
    // conic = (cs2, -cs1, cs0) inv, inv = 1 / (cs0 cs2 - cs1 cs1).
    const float g_inv =
        ADD(SUB(MUL(ga, k.cs[2]), MUL(gb, k.cs[1])), MUL(gc, k.cs[0]));
    const float g_det = -MUL(g_inv, MUL(k.inv, k.inv));
    const float g0 = ADD(MUL(gc, k.inv), MUL(g_det, k.cs[2]));
    const float g1 = -ADD(MUL(gb, k.inv), MUL(2.0f, MUL(g_det, k.cs[1])));
    const float g2 = ADD(MUL(ga, k.inv), MUL(g_det, k.cs[0]));
    // The safe covariance passes a gradient only where the row is visible.
    const float g00 = k.vis1 ? g0 : 0.0f;
    const float g01 = k.vis1 ? g1 : 0.0f;
    const float g11 = k.vis1 ? g2 : 0.0f;
    // cov = (t0 V t0, t1 V t0, t1 V t1): T's rows' gradients; V's through
    // g_u = g00 t0 + g01 t1 and g_v = g11 t1 as H = g_u t0^T + g_v t1^T
    // plus its transpose, whose gradient of M = R diag(s) is H M. (Formed
    // as a, b = M^T t0, M^T t1 first, the same sum cancels in float32 on
    // thin splats, where this order keeps autograd's accuracy.)
    const float e00 = MUL(2.0f, g00), e11 = MUL(2.0f, g11);
    float gt0[3], gt1[3], gu[3], gv[3], h[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gt0[j] = ADD(MUL(e00, k.u[j]), MUL(g01, k.q[j]));
      gt1[j] = ADD(MUL(g01, k.u[j]), MUL(e11, k.q[j]));
      gu[j] = ADD(MUL(g00, k.t0[j]), MUL(g01, k.t1[j]));
      gv[j] = MUL(g11, k.t1[j]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      h[4 * a] = MUL(2.0f, ADD(MUL(gu[a], k.t0[a]), MUL(gv[a], k.t1[a])));
#pragma unroll
      for (int b = a + 1; b < 3; ++b) {
        h[3 * a + b] = h[3 * b + a] =
            ADD(ADD(MUL(gu[a], k.t0[b]), MUL(gu[b], k.t0[a])),
                ADD(MUL(gv[a], k.t1[b]), MUL(gv[b], k.t1[a])));
      }
    }
    // M = R diag(s): the scales' and R's gradients.
    float gr[9], gls[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float gs = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float gm = MUL(h[4 * a], k.m[3 * a + j]);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          if (b != a) gm = ADD(gm, MUL(h[3 * a + b], k.m[3 * b + j]));
        }
        gs = a == 0 ? MUL(gm, k.r[j]) : ADD(gs, MUL(gm, k.r[3 * a + j]));
        gr[3 * a + j] = MUL(gm, k.s[j]);
      }
      gls[j] = MUL(gs, k.s[j]);
    }
    // R(q): the normalised quaternion's gradient.
    const float d21 = SUB(gr[7], gr[5]), d02 = SUB(gr[2], gr[6]),
                d10 = SUB(gr[3], gr[1]);
    const float s01 = ADD(gr[1], gr[3]), s02 = ADD(gr[2], gr[6]),
                s12 = ADD(gr[5], gr[7]);
    const float gqw =
        MUL(2.0f, ADD(ADD(MUL(k.qx, d21), MUL(k.qy, d02)), MUL(k.qz, d10)));
    const float gqx = SUB(
        MUL(2.0f, ADD(ADD(MUL(k.qy, s01), MUL(k.qz, s02)), MUL(k.qw, d21))),
        MUL(4.0f, MUL(k.qx, ADD(gr[4], gr[8]))));
    const float gqy = SUB(
        MUL(2.0f, ADD(ADD(MUL(k.qx, s01), MUL(k.qz, s12)), MUL(k.qw, d02))),
        MUL(4.0f, MUL(k.qy, ADD(gr[0], gr[8]))));
    const float gqz = SUB(
        MUL(2.0f, ADD(ADD(MUL(k.qx, s02), MUL(k.qy, s12)), MUL(k.qw, d10))),
        MUL(4.0f, MUL(k.qz, ADD(gr[0], gr[4]))));
    // q / clamp(|q|, 1e-12): (g - qn (qn . g)) / den, the norm's part
    // only where the clamp passes.
    const float dot = ADD(ADD(MUL(gqw, k.qw), MUL(gqx, k.qx)),
                          ADD(MUL(gqy, k.qy), MUL(gqz, k.qz)));
    const float kd = k.norm >= kNormMin ? dot : 0.0f;
    float gq[4] = {DIV(SUB(gqw, MUL(k.qw, kd)), k.den),
                   DIV(SUB(gqx, MUL(k.qx, kd)), k.den),
                   DIV(SUB(gqy, MUL(k.qy, kd)), k.den),
                   DIV(SUB(gqz, MUL(k.qz, kd)), k.den)};
    // T = J W; J from rz and t = z clamp(p rz).
    const float gja = dot3(gt0[0], w[0], gt0[1], w[1], gt0[2], w[2]);
    const float gjc0 = dot3(gt0[0], w[6], gt0[1], w[7], gt0[2], w[8]);
    const float gjb = dot3(gt1[0], w[3], gt1[1], w[4], gt1[2], w[5]);
    const float gjc1 = dot3(gt1[0], w[6], gt1[1], w[7], gt1[2], w[8]);
    const float hx = MUL(gjc0, c.fx), hy = MUL(gjc1, c.fy);
    const float g_tx = -MUL(hx, k.rz2), g_ty = -MUL(hy, k.rz2);
    const float g_rz =
        SUB(ADD(MUL(gja, c.fx), MUL(gjb, c.fy)),
            MUL(2.0f, MUL(ADD(MUL(hx, k.tx), MUL(hy, k.ty)), k.rz)));
    const bool in_x = k.vx >= c.lo_x && k.vx <= c.hi_x;
    const bool in_y = k.vy >= c.lo_y && k.vy <= c.hi_y;
    const float gz_t = ADD(in_x ? 0.0f : MUL(g_tx, k.vxc),
                           in_y ? 0.0f : MUL(g_ty, k.vyc));
    const float gz_c = SUB(gz_t, MUL(g_rz, k.rz2));
    // The covariance's chain, masked as the safe covariance masks it.
    const float gpx_c = k.vis1 && in_x ? g_tx : 0.0f;
    const float gpy_c = k.vis1 && in_y ? g_ty : 0.0f;
    const float gz_cv = k.vis1 ? gz_c : 0.0f;
    // xy = (p / z) f + c.
    const float ex = MUL(gx, c.fx), ey = MUL(gy, c.fy);
    const float gpx = ADD(DIV(ex, k.z), gpx_c);
    const float gpy = ADD(DIV(ey, k.z), gpy_c);
    const float gz = SUB(
        gz_cv, DIV(ADD(MUL(ex, DIV(k.px, k.z)), MUL(ey, DIV(k.py, k.z))),
                   k.z));
    const float gpz = k.vis0 ? gz : 0.0f;
    // p = W m + t.
    float* o = s_gmean.row(t);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[j] = dot3(w[j], gpx, w[3 + j], gpy, w[6 + j], gpz);
    }
    o = s_gscale.row(t);
#pragma unroll
    for (int j = 0; j < 3; ++j) o[j] = k.vis1 ? gls[j] : 0.0f;
    o = s_gquat.row(t);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = k.vis1 ? gq[j] : 0.0f;
  }
  __syncthreads();
  s_gmean.store(g_means, first, rows);
  s_gscale.store(g_log_scales, first, rows);
  s_gquat.store(g_quats, first, rows);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// The seven fields of Projection for n splats (active: n bytes, or null
// for all live), on `stream`; returns cudaGetLastError(). n may be 0.
extern "C" int project_fwd_launch(
    const float* means, const float* log_scales, const float* quats,
    const uint8_t* active, const float* viewmat, const float* focal,
    const float* center, int img_w, int img_h, int tiles_x, int tiles_y,
    int n, float* xy, float* depth, float* conic, int* radius,
    int* tile_min, int* tile_max, uint8_t* visible, void* stream) {
  if (n <= 0) return 0;
  project_fwd_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      means, log_scales, quats, active, viewmat, focal, center, img_w, img_h,
      tiles_x, tiles_y, n, xy, depth, conic, radius, tile_min, tile_max,
      visible);
  return static_cast<int>(cudaGetLastError());
}

// The gradients of means, log_scales (n, 3) and quats (n, 4) from those of
// xy (n, 2) and conic (n, 3), on `stream`; returns cudaGetLastError().
extern "C" int project_bwd_launch(
    const float* means, const float* log_scales, const float* quats,
    const uint8_t* active, const float* viewmat, const float* focal,
    const float* center, int img_w, int img_h, int n, const float* g_xy,
    const float* g_conic, float* g_means, float* g_log_scales,
    float* g_quats, void* stream) {
  if (n <= 0) return 0;
  project_bwd_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      means, log_scales, quats, active, viewmat, focal, center, img_w, img_h,
      n, g_xy, g_conic, g_means, g_log_scales, g_quats);
  return static_cast<int>(cudaGetLastError());
}
