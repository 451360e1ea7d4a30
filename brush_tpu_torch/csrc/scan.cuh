// The TPU kernels' truncated log-T scan (scan_passes), shared by
// rasterize_fwd.cu and rasterize_bwd.cu.
//
// brush_tpu/ops/pallas/rasterize_fwd.py, _cumsum_lanes_mxu (:153-197),
// takes each batch's prefix sums on the MXU: a scanned value x is split
// into `passes` bfloat16 parts, each rounded to nearest even (c0 = bf16(x),
// c1 = bf16(x - c0), ..), and the parts' prefix sums are added. At
// passes = 2 a term keeps about 16 mantissa bits; at 3 or more the scan is
// exact up to order, which the kernels' exact path computes. Batches are
// k_lanes records from the 128-aligned slot at or below the cell's start
// (rasterize_fwd.py:318, rasterize_bwd.py:107-110); k_lanes % 128 != 0
// takes the exact scan (rasterize_fwd.py:171-172). The plain versions are
// ops/cuda/rasterize_fwd.py's bf16_parts and scan_batches.
//
// The kernels carry T as a running product in this mode too: a record's
// term log1p(-alpha) cut to its parts is the exact term less the rest
// r = x - parts, so T moves by (1 - alpha) exp(-r); |r| <= 2^-16 |x| at
// two parts (|x| <= 6.91 at ALPHA_MAX), and exp(r) is 1 + r within float32
// rounding there (times_exp).

#pragma once

constexpr int kLaneAlign = 128;  // the TPU kernels' batch alignment

// x rounded to the nearest bfloat16, ties to even, as float (finite x; the
// scanned values are log1p(-alpha) with alpha <= ALPHA_MAX and products of
// finite colours and weights).
__device__ __forceinline__ float bf16_round(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// The sum of x's first kPasses bfloat16 parts, added in order (exact in
// float32: the parts span at most 8 bits each with no gap).
template <int kPasses>
__device__ __forceinline__ float scan_term(float x) {
  float rem = x, acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const float c = bf16_round(rem);
    rem = __fsub_rn(rem, c);
    acc = __fadd_rn(acc, c);
  }
  return acc;
}

// x less scan_term<kPasses>(x), exactly (each subtraction is).
template <int kPasses>
__device__ __forceinline__ float scan_rest(float x) {
  float rem = x;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) rem = __fsub_rn(rem, bf16_round(rem));
  return rem;
}

// v exp(r) for a rest r of scan_rest<kPasses>(log1p(-alpha)): one rounding
// of v (1 + r) at two parts or more (r^2 / 2 <= 5.5e-9, under half an ulp
// of 1); at one part (|r| <= 0.0135) a cubic, whose next term is 1.4e-9.
template <int kPasses>
__device__ __forceinline__ float times_exp(float v, float r) {
  if constexpr (kPasses >= 2) {
    return fmaf(v, r, v);
  } else {
    return v * fmaf(r, fmaf(r, fmaf(r, 1.0f / 6.0f, 0.5f), 1.0f), 1.0f);
  }
}

// The first slot of the scan batch that holds slot j, for a cell whose
// batches start at base (its start rounded down to kLaneAlign); a mask
// where k_lanes is a power of two.
__device__ __forceinline__ int scan_batch_start(int j, int base, int k_lanes) {
  const int off = j - base;
  return base + ((k_lanes & (k_lanes - 1)) == 0 ? off & -k_lanes
                                                 : off / k_lanes * k_lanes);
}
