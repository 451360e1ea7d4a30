// Forward tile rasterizer over the packed record pool (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/rasterize_fwd.py, rasterize_fwd_pallas
// (:500) and its body _make_kernel (:264) — the TPU kernel evaluates
// sigma as a rank-6 polynomial on the MXU and the transmittance as an MXU
// prefix scan over 512-record batches.
//
// What it computes, per raster cell c of cell_w x cell_h tiles (a tile at
// cell (1, 1)) and pixel i of its P = 256 cell_w cell_h, row-major over the
// whole cell (centre (cx*16 cell_w + i % (16 cell_w) + 0.5,
// cy*16 cell_h + i / (16 cell_w) + 0.5)), over the cell's records
// [starts[c], ends[c]) in depth order:
//   sigma = 0.5 (cxx dx^2 + cyy dy^2) + cxy dx dy,  d = record xy - pixel
//   alpha = min(ALPHA_MAX, o exp(-max(sigma, 0)))
//   the record counts if sigma >= 0 and alpha >= ALPHA_EPS; then
//   T_after = T (1 - alpha); if T_after <= 1e-4 the pixel stops for good
//   (the crossing record is not composited, the reference's sticky
//   `done`); else rgb += alpha T c, T = T_after, final_idx = the record's
//   pool index.
// Outputs: img (C, P, 4) = (rgb, 1 - T), log_t (C, P) = log T,
// final_idx (C, P) (-1 where nothing contributed).
// (The reference and the PyTorch version carry log T, as a sum of
// log1p(-alpha), and take exp(log T) for every record that contributes.
// The running product is the same quantity with one rounding a record in
// place of three, and one logf a pixel at the end: on the card it lies
// nearer to the PyTorch version's cumsum than the sequential sum of logs
// does, and it takes a log1pf and an expf out of every active pair.
// rasterize_bwd.cu carries T the same way, backwards.)
//
// Bound on the H100: operations. Every (pixel, record) pair a pixel reaches
// needs 13 float32 operations (sigma and the two compares of the pretest
// below), and a pair that passes 7 more, one exp among them; the records
// themselves are 28 bytes each, read once per tile. That bound counts
// lanes, not warps, and exp at the float32 rate: in the bench scene about
// 8 % of the pairs contribute, and a warp pays for 32 lanes whenever one
// does.
//
// What held the first version back (one 256-thread block a tile, one
// thread a pixel, 256 records staged per batch, one record a loop step):
//   1. nine 4-byte broadcast loads from nine shared arrays per record for
//      about eleven float operations: the loads set the pace;
//   2. expf, the clamp and two compares ran for every pair, though few
//      pairs contribute;
//   3. one dependent chain a thread (`alive &&` carried from record to
//      record), and with a few heavy tiles an SM each scheduler ran about
//      one such chain;
//   4. tiles launched in index order, so the SMs that drew several heavy
//      tiles ran long after the others had gone idle;
//   5. records staged by plain loads between two barriers, nothing in
//      flight while a batch was swept.
//
// Design, on the CUDA cores; what it says was measured, was measured on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit with the bench scene (1M
// random splats, 1024x1024) by scripts/torch_kernel_variants.py, where this
// kernel takes 0.63 ms (5.7 times the bound above, 0.11 ms) and the first
// version 1.95-1.99. The TPU kernel's polynomial sigma on the MXU and its
// MXU prefix scan of log1p(-alpha) are not carried over: TF32
// products would not hold the 1e-5 tolerance (the polynomial's
// cancellation already costs the TPU kernel up to 7e-5 on log T), and a
// scan over a whole batch evaluates every pair behind a pixel's crossing.
//   - Records as a structure (1). Each batch is decoded once into 12-float
//     records in shared memory: x y cxx cxy | cyy sigma_max o r | g b. The
//     common path reads one 16-byte and one 8-byte broadcast load a record;
//     opacity and colour are read only for records that reach the warp.
//   - The sigma pretest (2). A pair is kept only if 0 <= sigma <=
//     log(255 o) + a margin, without which alpha cannot reach ALPHA_EPS;
//     the bound is computed once a record at decode. exp, the clamp and
//     the accumulation run only for pairs that are all but surely active.
//     The test is rasterize_bwd.cu's, so the two kernels sweep the same
//     active set.
//   - Eight records a step (3). A step first computes the kUnroll sigmas
//     of a thread, independent of one another, so one warp keeps the
//     pipeline full; then it takes the pairs that passed in depth order.
//     One warp-wide OR tells which records of the step reach the warp at
//     all. A warp covers a compact 8x4 patch, so a small splat touches few
//     warps. One pixel a thread: with a few heavy tiles an SM, eight warps
//     a tile hide more latency than the loads and the shared dy of two or
//     four pixels a thread save (two and four pixels a thread measured
//     19 % and 64 % slower, and the code for them is gone; 4 and 16
//     records a step 13 % and 23 %).
//   - T as a running product, so an active pair costs an expf, five
//     multiplies and three fused multiply-adds and no log1pf (a third
//     slower with the sum of logs).
//   - The early-out. A pixel that crossed the threshold drops out of the
//     pretest; a warp whose pixels have all crossed skips its sweeps, and
//     the block leaves its loop when no pixel of the tile is live. The
//     crossing record is not composited and nothing behind it is.
//   - Heavy tiles first (4). Block b takes tile order[b] (tile_order.cuh).
//     (Dealing the head of the order to the SMs by %smid evened the
//     records an SM to within 4 % and gained under 2 %: left out.)
//   - Raster cells (the TPU kernel's cell=(gw, gh) mode, rasterize_fwd.py
//     :201-240): one block a 16x16 tile of a cell, cell_w cell_h blocks a
//     cell, each sweeping the whole cell's record range for its own 256
//     pixels. Pixels are independent in the forward, so the body is the
//     tile body with the pixel origin moved to the tile's place in its cell
//     and the output index counted row-major over the cell; block b takes
//     cell order[b / (cell_w cell_h)] (heavy cells first) and its tile
//     b % (cell_w cell_h). Any cell size runs: the block shape does not
//     change with it. At cell (1, 1) every pixel's arithmetic and output
//     index are those of the tile kernel, bit for bit. The TPU kernel's
//     knobs that the cell changes (its k_lanes VMEM budget and the
//     tiles_per_step shrink, raster_vjp.py:154-168) are Mosaic scoped-VMEM
//     limits and have no counterpart here.
//   - Asynchronous staging (5). The next batch's seven packed rows arrive
//     by cp.async while this batch is swept; decode happens on arrival.
//     384 records a batch (29 KB) measured 2 % faster than 192.
// What is left: the sweep is bound by issue slots. About 19 instructions a
// (warp, record) are the common path (eleven of them sigma's separately
// rounded operations, which the agreement with the PyTorch version and the
// backward forbids to fuse), and more than half of the (warp, record)s
// hold an active lane, though only 8 % of the pairs are active.
// No atomics on floats and no exchange between threads: a pixel's sums are
// one thread's, in depth order, so two launches are bit-equal (the tile
// order's integer atomics move no result). Sigma, the opacity and colour
// decode and alpha use explicitly rounded intrinsics (no fused
// multiply-add) and expf, so each is the value the PyTorch version
// computes op by op and the set of pairs that count is the same there, here
// and in rasterize_bwd.cu.

#include <cuda_runtime.h>

#include "tile_order.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = kPixels;  // one pixel a thread
constexpr int kUnroll = 8;         // records a step of the sweep
constexpr int kBatch = 384;   // records staged per batch (see the header)
constexpr int kRawRows = 7;   // packed rows the sweep reads (row 7: ids)
constexpr int kRecFloats = 12;  // x y cxx cxy | cyy sigma_max o r | g b - -
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaEps = static_cast<float>(1.0 / 255.0);
constexpr float kTEps = 1e-4f;  // TRANSMITTANCE_EPS
constexpr float kColorLo = -4.0f;
constexpr float kColorStep = static_cast<float>(1.0 / (65535.0 / 8.0));
constexpr float kOpacStep = static_cast<float>(1.0 / 65535.0);
constexpr float kSigmaMargin = 1e-4f;  // see the decode

static_assert(kUnroll <= 32, "one bit a record in a step");
static_assert(kBatch % kUnroll == 0, "a batch is padded to whole steps");

__device__ __forceinline__ float decode_color(unsigned q) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), kColorStep), kColorLo);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kCells: cells of several tiles (cell_w cell_h > 1); false compiles the
// tile kernel, without the division that maps a block to its cell.
template <bool kCells>
__global__ void __launch_bounds__(kThreads)
rasterize_fwd_kernel(const int* __restrict__ packed, int pool,
                     const int* __restrict__ order,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int cells_x, int cell_w,
                     int cell_h, float* __restrict__ img,
                     float* __restrict__ log_t_out,
                     int* __restrict__ fidx_out) {
  __shared__ int s_raw[kRawRows][kBatch];
  __shared__ __align__(16) float s_rec[kBatch][kRecFloats];

  const int tiles_a_cell = kCells ? cell_w * cell_h : 1;
  const int t = order[kCells ? blockIdx.x / tiles_a_cell : blockIdx.x];
  const int sub = kCells ? blockIdx.x % tiles_a_cell : 0;  // tile in cell
  if (!kCells) cell_w = cell_h = 1;
  const int cell_px = kTile * cell_w;  // pixels a cell row
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int warp = tid >> 5;
  const size_t P = static_cast<size_t>(pool);
  const int start = starts[t];
  const int end = ends[t];

  // This thread's pixel: warp w covers the 8 wide, 4 high patch w of the
  // tile (two patches to a row), the lane is (lane % 8, lane / 8) inside;
  // (lx, ly) counts from the cell's corner.
  const int lx = (lane & 7) + (warp & 1) * 8 + (sub % cell_w) * kTile;
  const int ly = (lane >> 3) + (warp >> 1) * 4 + (sub / cell_w) * kTile;
  const float px = static_cast<float>((t % cells_x) * cell_px + lx) + 0.5f;
  const float py =
      static_cast<float>((t / cells_x) * kTile * cell_h + ly) + 0.5f;

  float t_cur = 1.0f;  // T so far
  float r = 0.0f, g = 0.0f, b = 0.0f;
  int fidx = -1;
  bool alive = true;      // the pixel has not crossed the threshold
  bool warp_live = true;  // some pixel of the warp has not

  auto stage = [&](int b_start, int count) {
    for (int row = 0; row < kRawRows; ++row) {
      const int* src = packed + row * P + b_start;
      for (int k = tid; k < count; k += kThreads) {
        cp_async4(&s_raw[row][k], src + k);
      }
    }
    cp_async_commit();
  };

  if (start < end) stage(start, min(kBatch, end - start));
  for (int base = start; base < end; base += kBatch) {
    const int count = min(kBatch, end - base);
    cp_async_wait_all();
    // The batch has arrived and the last sweep ended. The tile is done
    // once none of its pixels is live.
    if (__syncthreads_or(alive) == 0) break;
    // Decode, padded to whole steps with records no pair can pass.
    const int padded = (count + kUnroll - 1) / kUnroll * kUnroll;
    for (int k = tid; k < padded; k += kThreads) {
      float4* rec = reinterpret_cast<float4*>(s_rec[k]);
      if (k >= count) {
        rec[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        rec[1] = make_float4(0.0f, __int_as_float(0xff800000) /* -inf */,
                             0.0f, 0.0f);
        continue;
      }
      const unsigned c0 = static_cast<unsigned>(s_raw[5][k]);
      const unsigned c1 = static_cast<unsigned>(s_raw[6][k]);
      rec[0] = make_float4(__int_as_float(s_raw[0][k]),
                           __int_as_float(s_raw[1][k]),
                           __int_as_float(s_raw[2][k]),
                           __int_as_float(s_raw[3][k]));
      const float o = __fmul_rn(static_cast<float>(c1 >> 16), kOpacStep);
      // alpha >= ALPHA_EPS needs o exp(-sigma) >= 1 / 255: no pair with
      // sigma above log(255 o), and a margin far wider than the rounding
      // of expf and the product, can be active (o = 0 gives -inf).
      rec[1] = make_float4(__int_as_float(s_raw[4][k]),
                           logf(255.0f * o) + kSigmaMargin, o,
                           decode_color(c0 & 0xFFFFu));
      rec[2] = make_float4(decode_color(c0 >> 16),
                           decode_color(c1 & 0xFFFFu), 0.0f, 0.0f);
    }
    __syncthreads();  // s_rec is whole, s_raw is free
    if (base + kBatch < end) {
      stage(base + kBatch, min(kBatch, end - base - kBatch));
    }
    if (!warp_live) continue;  // warp-uniform

    // The sweep, kUnroll records at a time. First every record's sigma
    // and its test, independent of one another; then, record by record
    // front to back, those that passed.
    for (int k0 = 0; k0 < count; k0 += kUnroll) {
      float sigma[kUnroll];
      unsigned mine = 0;  // bit u: record k0 + u passed for this pixel
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 ra4 = *reinterpret_cast<const float4*>(s_rec[k0 + u]);
        const float2 rb2 =
            *reinterpret_cast<const float2*>(&s_rec[k0 + u][4]);
        const float x = ra4.x, y = ra4.y, cxx = ra4.z, cxy = ra4.w;
        const float cyy = rb2.x, sigma_max = rb2.y;
        const float dx = __fsub_rn(x, px);
        const float dy = __fsub_rn(y, py);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(cxx, dx), dx),
                                     __fmul_rn(__fmul_rn(cyy, dy), dy));
        sigma[u] = __fadd_rn(__fmul_rn(0.5f, quad),
                             __fmul_rn(__fmul_rn(cxy, dx), dy));
        // A pixel that crossed takes no further record.
        const bool maybe =
            alive && sigma[u] >= 0.0f && sigma[u] <= sigma_max;
        mine |= static_cast<unsigned>(maybe) << u;
      }
      const unsigned warps = __reduce_or_sync(kFull, mine);
      if (warps == 0) continue;  // warp-uniform
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!((warps >> u) & 1u)) continue;  // warp-uniform
        const float2 oc = *reinterpret_cast<const float2*>(&s_rec[k0 + u][6]);
        const float2 gb = *reinterpret_cast<const float2*>(&s_rec[k0 + u][8]);
        if (!(alive && ((mine >> u) & 1u))) continue;
        const float vis = expf(-sigma[u]);
        const float alpha = fminf(kAlphaMax, __fmul_rn(oc.x, vis));
        if (alpha < kAlphaEps) continue;
        const float after = t_cur * (1.0f - alpha);
        if (after <= kTEps) {
          alive = false;
          continue;
        }
        const float fac = alpha * t_cur;
        r = fmaf(fac, oc.y, r);
        g = fmaf(fac, gb.x, g);
        b = fmaf(fac, gb.y, b);
        t_cur = after;
        fidx = base + k0 + u;
      }
      warp_live = __any_sync(kFull, alive);
      if (!warp_live) break;
    }
  }

  const size_t p = static_cast<size_t>(t) * kPixels * tiles_a_cell +
                   static_cast<size_t>(ly) * cell_px + lx;
  reinterpret_cast<float4*>(img)[p] = make_float4(r, g, b, 1.0f - t_cur);
  log_t_out[p] = logf(t_cur);
  fidx_out[p] = fidx;
}

}  // namespace

// num_cells cells of cell_w x cell_h tiles, cells_x a row; (1, 1) for
// tiles. order: num_cells ints of scratch.
extern "C" int rasterize_fwd_launch(const int* packed, int pool,
                                    const int* starts, const int* ends,
                                    int num_cells, int cells_x, int cell_w,
                                    int cell_h, float* img, float* log_t,
                                    int* fidx, int* order, void* stream) {
  if (num_cells <= 0) return 0;
  if (cell_w < 1 || cell_h < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(num_cells) * cell_w * cell_h;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(starts, ends, num_cells,
                                                order);
  if (blocks == num_cells) {
    rasterize_fwd_kernel<false><<<num_cells, kThreads, 0, s>>>(
        packed, pool, order, starts, ends, cells_x, 1, 1, img, log_t, fidx);
  } else {
    rasterize_fwd_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(packed, pool, order, starts, ends,
                                      cells_x, cell_w, cell_h, img, log_t,
                                      fidx);
  }
  return static_cast<int>(cudaGetLastError());
}
