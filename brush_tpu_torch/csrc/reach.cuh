// Which records may reach a rectangle of pixel centres, shared by
// rasterize_fwd.cu and rasterize_bwd.cu (the build hashes every header
// into each library's name, so an edit here rebuilds both).
//
// Both sweeps keep a (pixel, record) pair only if 0 <= sigma <= sigma_max
// (the pretest: alpha cannot reach ALPHA_EPS above it). A record whose
// least sigma over a rectangle that holds a set of pixels exceeds
// sigma_max passes the pretest for none of them, so a sweep may leave it
// out of that set's work and change no bit of any output. The forward
// tests each record against its block's 16x16 tile and then its warps'
// 8x4 patches, the backward against its warps' 16x4 patches.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kReachMargin = 1e-5f;  // see may_reach

__device__ __forceinline__ float quad_sigma(float cxx, float cxy, float cyy,
                                            float dx, float dy) {
  return 0.5f * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy;
}

// False only if no pixel centre of the rectangle [xa, xb] x [ya, yb] can
// pass the sweep's pretest sigma <= sigma_max. Over the rectangle, d = xy -
// pixel spans [x - xb, x - xa] x [y - yb, y - ya], and the sweep's rounded
// d of every centre lies in that box (the same subtractions, and rounding
// is monotone). A positive-definite conic whose centre lies outside the box
// takes its least sigma on an edge, a one-dimensional quadratic minimized
// at its clamped vertex. The sweep's sigma rounds by a few ulp of
// |cxx| dx^2 + |cyy| dy^2 + 2 |cxy dx dy|, and so does this one: the
// margin, 1e-5 of that magnitude over the box, is about 170 ulp. Any other
// conic, and any NaN in the test, keeps the record.
__device__ __forceinline__ bool may_reach(float x, float y, float cxx,
                                          float cxy, float cyy,
                                          float sigma_max, float xa, float xb,
                                          float ya, float yb) {
  if (!(cxx > 0.0f && cyy > 0.0f && cxx * cyy - cxy * cxy > 0.0f)) {
    return true;
  }
  const float dxl = x - xb, dxh = x - xa, dyl = y - yb, dyh = y - ya;
  if (!(dxl > 0.0f || dxh < 0.0f || dyl > 0.0f || dyh < 0.0f)) return true;
  float least = quad_sigma(
      cxx, cxy, cyy, fminf(fmaxf(-cxy * dyl / cxx, dxl), dxh), dyl);
  least = fminf(least, quad_sigma(
      cxx, cxy, cyy, fminf(fmaxf(-cxy * dyh / cxx, dxl), dxh), dyh));
  least = fminf(least, quad_sigma(
      cxx, cxy, cyy, dxl, fminf(fmaxf(-cxy * dxl / cyy, dyl), dyh)));
  least = fminf(least, quad_sigma(
      cxx, cxy, cyy, dxh, fminf(fmaxf(-cxy * dxh / cyy, dyl), dyh)));
  const float mx = fmaxf(fabsf(dxl), fabsf(dxh));
  const float my = fmaxf(fabsf(dyl), fabsf(dyh));
  const float mag =
      cxx * mx * mx + cyy * my * my + 2.0f * fabsf(cxy) * mx * my;
  return !(least > sigma_max + kReachMargin * (mag + 1.0f));
}

}  // namespace
