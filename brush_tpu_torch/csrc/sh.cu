// The SH colour of every splat and its backward (sm_90a): the view
// direction, the spherical-harmonics basis of degree 0-4 at it and the
// basis' contraction with the splat's coefficients; backward, the
// coefficients' gradient.
//
// Replaces no TPU kernel: brush_tpu/ops/sh.py (sh_basis, sh_to_color) is
// plain XLA, which fuses the basis and the contraction on the TPU. Its
// port in plain PyTorch (ops/sh.py, the CPU path and these kernels' twin)
// runs about thirty basis passes, a stack and one multiply-add a
// coefficient on strided slices; under autograd each coefficient's slice
// then zero-fills a whole (N, K, 3) gradient (1.0 GB at 5,242,880 splats,
// K = 16), and autograd adds the K of them. On the bicycle training step
// that was 12.3 ms forward and 27.6 ms backward of 99.
//
// What they compute, per splat n, with KD = (degree + 1)^2 <= K of the K
// coefficients a row holds (ops/rasterize_reference.view_colors):
//   d = means[n] - campos, d / max(|d|, 1e-12); b = ops/sh.sh_basis at d;
//   forward:  color[n, c] = (...((b_0 c_0 + b_1 c_1) + b_2 c_2)...) + 0.5,
//             c_i = coeffs[n, i, c];
//   backward: g_coeffs[n, i, c] = b_i g[n, c] + 0 for i < KD, 0 past KD.
// No gradient reaches the means: the view direction is a constant for
// autograd, as in the reference. The backward recomputes the basis from
// the means (12 bytes a splat) rather than keep it (4 KD bytes).
//
// Bound on the H100: bytes. The forward reads the means (12 B) and 12 K B
// of coefficients and writes the colour (12 B); the backward reads the
// means and the colour's gradient (24 B) and writes 12 K B: 216 B a splat
// each way at K = 16, 0.34 ms at 5,242,880 splats at 3.35 TB/s. About 100
// float operations a splat at degree 3: far below the card's float rate.
//
// Design: one thread a splat, kThreads = 128 a block. A block's
// coefficient rows are one contiguous run of 128 x 12 K bytes (a multiple
// of 16). The block moves it through shared memory, neighbouring threads
// on neighbouring words: 16-byte words where rows are whole words (K % 4
// == 0) and the run is 16-byte aligned, single floats otherwise. So a
// warp's global loads (forward) and stores (backward) are contiguous, and
// each thread reads or writes its own row in shared memory. Only a row's
// first KD coefficients are staged; the backward writes the rest of each
// row as zeros. Rows in shared memory are padded to an odd number of
// words, so the threads of a warp, each at its own row, meet no bank
// conflict. At most 38,912 bytes a block (degree 4). The degree and the
// word are template parameters, picked on the host from the degree, K and
// the coefficients' address. Why both words: at K = 16 on an H100 80GB
// HBM3 (700 W), single floats took the forward 0.430 device ms at
// 5,242,880 rows against the 16-byte words' 0.372 (0.685 against 0.591
// at 8,388,608), the backward 0.406 against 0.398; the single floats stay
// for rows that are not whole words.
//
// Numerics: the basis is ops/sh.sh_basis's, term by term and in its
// order, the contraction in the plain code's order, every product, sum,
// difference and quotient through __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which nvcc never contracts into an FMA (PyTorch's elementwise
// kernels round each op). The constants are the plain code's Python floats
// rounded to float32, as PyTorch rounds a Python scalar operand. So at the
// same directions the colours and the gradients are the twins' bit for
// bit. The + 0 in the backward turns a -0 product into the +0 that
// autograd's zero-filled slices add to it (at degree >= 1). The
// direction's norm is sqrtf((dx dx + dz dz) + dy dy) (ops/sh.
// view_dirs_plain), the order in which torch.linalg.vector_norm's CUDA
// reduction sums the three squares (two threads a row: x and z, then y);
// on the card the two gave the same norm on every row of a 5,242,880- and
// an 8,388,608-row draw, so the colours are then the plain path's. The
// CPU's vector_norm may sum them in another order, an ulp apart.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

// A Python float's float32 value, as PyTorch rounds a scalar operand.
#define F32(v) static_cast<float>(v)

template <int V>
struct Word;
template <>
struct Word<1> {
  using type = float;
};
template <>
struct Word<4> {
  using type = float4;
};

__device__ __forceinline__ void unpack(float w, float* f) { f[0] = w; }
__device__ __forceinline__ void unpack(float4 w, float* f) {
  f[0] = w.x;
  f[1] = w.y;
  f[2] = w.z;
  f[3] = w.w;
}
__device__ __forceinline__ void pack(const float* f, float& w) { w = f[0]; }
__device__ __forceinline__ void pack(const float* f, float4& w) {
  w = make_float4(f[0], f[1], f[2], f[3]);
}

// A staged row of degree D in words of V floats: its first 3 KD floats,
// rounded up to whole words, at an odd stride.
template <int D, int V>
struct Row {
  static constexpr int kCoeffs = (D + 1) * (D + 1);
  static constexpr int kWords = (3 * kCoeffs + V - 1) / V;
  static constexpr int kFloats = kWords * V;
  static constexpr int kStride = kWords | 1;
};

// The unit view direction of splat i (view_colors: clamp, then divide).
__device__ __forceinline__ void view_dir(const float* __restrict__ means,
                                         const float* __restrict__ campos,
                                         int cs, size_t i, float& x,
                                         float& y, float& z) {
  const float dx = __fsub_rn(means[3 * i], campos[0]);
  const float dy = __fsub_rn(means[3 * i + 1], campos[cs]);
  const float dz = __fsub_rn(means[3 * i + 2], campos[2 * cs]);
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)), __fmul_rn(dy, dy)));
  // torch.clamp(min=1e-12): a NaN norm stays NaN.
  const float den = norm < F32(1e-12) ? F32(1e-12) : norm;
  x = __fdiv_rn(dx, den);
  y = __fdiv_rn(dy, den);
  z = __fdiv_rn(dz, den);
}

// ops/sh.sh_basis, band-major, term by term.
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = F32(0.2820947917738781);   // constants.SH_C0
  if constexpr (D >= 1) {
    b[1] = __fmul_rn(F32(-0.48860251190292), y);
    b[2] = __fmul_rn(F32(0.48860251190292), z);
    b[3] = __fmul_rn(F32(-0.48860251190292), x);
  }
  const float z2 = __fmul_rn(z, z);
  const float fc1 = __fsub_rn(__fmul_rn(x, x), __fmul_rn(y, y));
  const float fs1 = __fmul_rn(__fmul_rn(2.0f, x), y);
  const float p6 = __fsub_rn(__fmul_rn(F32(0.9461746957575601), z2),
                             F32(0.3153915652525201));
  if constexpr (D >= 2) {
    const float f0b = __fmul_rn(F32(-1.092548430592079), z);
    const float f1a = F32(0.5462742152960395);
    b[4] = __fmul_rn(f1a, fs1);
    b[5] = __fmul_rn(f0b, y);
    b[6] = p6;
    b[7] = __fmul_rn(f0b, x);
    b[8] = __fmul_rn(f1a, fc1);
  }
  const float fc2 = __fsub_rn(__fmul_rn(x, fc1), __fmul_rn(y, fs1));
  const float fs2 = __fadd_rn(__fmul_rn(x, fs1), __fmul_rn(y, fc1));
  const float p12 = __fmul_rn(
      z, __fsub_rn(__fmul_rn(F32(1.865881662950577), z2),
                   F32(1.119528997770346)));
  if constexpr (D >= 3) {
    const float f0c = __fadd_rn(__fmul_rn(F32(-2.285228997322329), z2),
                                F32(0.4570457994644658));
    const float f1b = __fmul_rn(F32(1.445305721320277), z);
    const float f2a = F32(-0.5900435899266435);
    b[9] = __fmul_rn(f2a, fs2);
    b[10] = __fmul_rn(f1b, fs1);
    b[11] = __fmul_rn(f0c, y);
    b[12] = p12;
    b[13] = __fmul_rn(f0c, x);
    b[14] = __fmul_rn(f1b, fc1);
    b[15] = __fmul_rn(f2a, fc2);
  }
  if constexpr (D >= 4) {
    const float f0d = __fmul_rn(
        z, __fadd_rn(__fmul_rn(F32(-4.683325804901025), z2),
                     F32(2.007139630671868)));
    const float f1c = __fsub_rn(__fmul_rn(F32(3.31161143515146), z2),
                                F32(0.47308734787878));
    const float f2b = __fmul_rn(F32(-1.770130769779931), z);
    const float f3a = F32(0.6258357354491763);
    const float fc3 = __fsub_rn(__fmul_rn(x, fc2), __fmul_rn(y, fs2));
    const float fs3 = __fadd_rn(__fmul_rn(x, fs2), __fmul_rn(y, fc2));
    const float p20 = __fsub_rn(
        __fmul_rn(__fmul_rn(F32(1.984313483298443), z), p12),
        __fmul_rn(F32(1.006230589874905), p6));
    b[16] = __fmul_rn(f3a, fs3);
    b[17] = __fmul_rn(f2b, fs2);
    b[18] = __fmul_rn(f1c, fs1);
    b[19] = __fmul_rn(f0d, y);
    b[20] = p20;
    b[21] = __fmul_rn(f0d, x);
    b[22] = __fmul_rn(f1c, fc1);
    b[23] = __fmul_rn(f2b, fc2);
    b[24] = __fmul_rn(f3a, fc3);
  }
}

template <int D, int V>
__global__ void __launch_bounds__(kThreads) sh_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ campos,
    int cs, const float* __restrict__ coeffs, int k, int n,
    float* __restrict__ color) {
  using W = typename Word<V>::type;
  using R = Row<D, V>;
  __shared__ W stage[kThreads * R::kStride];
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - first);
  const int row_words = 3 * k / V;
  const W* src = reinterpret_cast<const W*>(coeffs) +
                 static_cast<size_t>(first) * row_words;
  for (int u = threadIdx.x; u < rows * R::kWords; u += kThreads) {
    const int r = u / R::kWords;
    const int q = u - r * R::kWords;
    stage[r * R::kStride + q] = src[r * row_words + q];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= rows) return;
  float c[R::kFloats];
#pragma unroll
  for (int q = 0; q < R::kWords; ++q) {
    unpack(stage[t * R::kStride + q], c + q * V);
  }
  const size_t i = static_cast<size_t>(first) + t;
  float x, y, z;
  view_dir(means, campos, cs, i, x, y, z);
  float b[R::kCoeffs];
  sh_basis<D>(x, y, z, b);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = __fmul_rn(b[0], c[ch]);
#pragma unroll
    for (int j = 1; j < R::kCoeffs; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(b[j], c[3 * j + ch]));
    }
    color[3 * i + ch] = __fadd_rn(acc, 0.5f);
  }
}

template <int D, int V>
__global__ void __launch_bounds__(kThreads) sh_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ campos,
    int cs, const float* __restrict__ g_color, int k, int n,
    float* __restrict__ g_coeffs) {
  using W = typename Word<V>::type;
  using R = Row<D, V>;
  __shared__ W stage[kThreads * R::kStride];
  const int first = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - first);
  const int t = threadIdx.x;
  if (t < rows) {
    const size_t i = static_cast<size_t>(first) + t;
    float x, y, z;
    view_dir(means, campos, cs, i, x, y, z);
    float b[R::kCoeffs];
    sh_basis<D>(x, y, z, b);
    const float g[3] = {g_color[3 * i], g_color[3 * i + 1],
                        g_color[3 * i + 2]};
    float p[R::kFloats];
#pragma unroll
    for (int f = 0; f < R::kFloats; ++f) {
      p[f] = f < 3 * R::kCoeffs
                 ? __fadd_rn(__fmul_rn(b[f / 3], g[f % 3]), 0.0f)
                 : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < R::kWords; ++q) {
      pack(p + q * V, stage[t * R::kStride + q]);
    }
  }
  __syncthreads();
  // Word u of the block's run is word q of row r; (r, q) advance by
  // (kThreads / row_words, kThreads % row_words) with a carry.
  const int row_words = 3 * k / V;
  W* dst = reinterpret_cast<W*>(g_coeffs) +
           static_cast<size_t>(first) * row_words;
  int r = t / row_words;
  int q = t - r * row_words;
  const int dr = kThreads / row_words;
  const int dq = kThreads - dr * row_words;
  const W zero{};
  for (int u = t; u < rows * row_words; u += kThreads) {
    dst[u] = q < R::kWords ? stage[r * R::kStride + q] : zero;
    r += dr;
    q += dq;
    if (q >= row_words) {
      q -= row_words;
      ++r;
    }
  }
}

template <int D>
void launch(bool backward, bool vec, const float* means,
            const float* campos, int cs, const float* in, int k, int n,
            float* out, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (backward && vec) {
    sh_bwd_kernel<D, 4><<<blocks, kThreads, 0, s>>>(means, campos, cs, in,
                                                   k, n, out);
  } else if (backward) {
    sh_bwd_kernel<D, 1><<<blocks, kThreads, 0, s>>>(means, campos, cs, in,
                                                   k, n, out);
  } else if (vec) {
    sh_fwd_kernel<D, 4><<<blocks, kThreads, 0, s>>>(means, campos, cs, in,
                                                   k, n, out);
  } else {
    sh_fwd_kernel<D, 1><<<blocks, kThreads, 0, s>>>(means, campos, cs, in,
                                                   k, n, out);
  }
}

int dispatch(bool backward, const float* means, const float* campos,
             int cs, const float* in, int k, int n, int degree, float* out,
             const void* coeffs, void* stream) {
  if (n <= 0) return 0;
  const bool vec =
      k % 4 == 0 && reinterpret_cast<uintptr_t>(coeffs) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: launch<0>(backward, vec, means, campos, cs, in, k, n, out, s);
      break;
    case 1: launch<1>(backward, vec, means, campos, cs, in, k, n, out, s);
      break;
    case 2: launch<2>(backward, vec, means, campos, cs, in, k, n, out, s);
      break;
    case 3: launch<3>(backward, vec, means, campos, cs, in, k, n, out, s);
      break;
    case 4: launch<4>(backward, vec, means, campos, cs, in, k, n, out, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// color (n, 3) from means (n, 3), campos (3 floats, cs apart) and coeffs
// (n, k, 3), on `stream`; returns cudaGetLastError(). n may be 0.
extern "C" int sh_color_fwd_launch(const float* means, const float* campos,
                                   int cs, const float* coeffs, int k, int n,
                                   int degree, float* color, void* stream) {
  return dispatch(false, means, campos, cs, coeffs, k, n, degree, color,
                  coeffs, stream);
}

// g_coeffs (n, k, 3) from means, campos and the colour's gradient g_color
// (n, 3), on `stream`; returns cudaGetLastError(). n may be 0.
extern "C" int sh_color_bwd_launch(const float* means, const float* campos,
                                   int cs, const float* g_color, int k, int n,
                                   int degree, float* g_coeffs,
                                   void* stream) {
  return dispatch(true, means, campos, cs, g_color, k, n, degree, g_coeffs,
                  g_coeffs, stream);
}
