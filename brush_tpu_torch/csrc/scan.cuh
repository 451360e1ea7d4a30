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

// The sum of x's first `passes` bfloat16 parts, added in order (exact in
// float32: the parts span at most 8 bits each with no gap).
__device__ __forceinline__ float scan_term(float x, int passes) {
  float rem = x, acc = 0.0f;
  for (int i = 0; i < passes; ++i) {
    const float c = bf16_round(rem);
    rem = __fsub_rn(rem, c);
    acc = __fadd_rn(acc, c);
  }
  return acc;
}

// The first slot of the scan batch that holds slot j, for a cell whose
// batches start at base (its start rounded down to kLaneAlign).
__device__ __forceinline__ int scan_batch_start(int j, int base, int k_lanes) {
  return base + (j - base) / k_lanes * k_lanes;
}
