// Backward tile rasterizer: per-record gradient rows in tile order (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/rasterize_bwd.py, rasterize_bwd_pallas
// (:414) and its body _make_bwd_kernel (:56, per-batch math :199-346) —
// the TPU kernel rebuilds log T with an MXU prefix scan over 512-record
// batches and sums each record's terms over the tile's pixels as moment
// matmuls on the MXU (v_sigma against [1, px, py, px^2, py^2, px py]).
//
// What it computes, per raster cell c of cell_w x cell_h tiles (a tile at
// cell (1, 1)) and pixel i of its P = 256 cell_w cell_h, row-major over the
// cell as in rasterize_fwd.cu, sweeping the cell's records back to front
// from min(end, max_i final_idx + 1) - 1 down to start, with
// T = t_final = exp(log_t) (the forward's log T) and s_behind = 0:
//   sigma, vis = exp(-max(sigma, 0)), alpha = min(ALPHA_MAX, o vis), as in
//   the forward; the record is active iff j <= final_idx, sigma >= 0 and
//   alpha >= ALPHA_EPS. Then
//   t_before = T / (1 - alpha), fac = alpha t_before, cw = c . v_rgb,
//   v_alpha = cw t_before - s_behind / (1 - alpha) + t_final v_a / (1 - alpha)
//   s_behind += cw fac, T = t_before, vs = -o vis v_alpha, d = xy - pixel;
//   terms: vs (cxx dx + cxy dy), vs (cxy dx + cyy dy), vs dx^2 / 2,
//   vs dx dy, vs dy^2 / 2, fac v_rgb (3), vis v_alpha.
// (t_before is the reference's exp(log T - log1p(-alpha)), carried as a
// running product: one reciprocal in place of a log1p and an exp, and
// rounding of the same order.) The ALPHA_MAX clamp is ignored in the sigma
// and opacity terms, as in the TPU kernel (rasterize_bwd.py:228-304). Each
// term is summed over the cell's P pixels and written to
// grads[row * pool + j]; slots no sweep reaches keep the zeros the wrapper
// allocated.
//
// Bound on the H100: operations. Every (pixel, record) pair of the sweep
// needs the forward's 13 float32 operations (sigma and the pretest's two
// compares), and each active pair 7 for alpha and ~45 more, the nine-term
// pixel reduction's share among them; records are 28 bytes read and 36
// written. That bound counts lanes, not warps: in the bench scene about
// 8 % of the pairs are active, and a warp pays for 32 lanes whenever one
// is. It also counts exp and the reciprocal at the float32 rate.
//
// The tile sweep (one block of 128 threads a tile, two pixels a thread,
// four records a step, a sigma pretest, one folded butterfly for the nine
// pixel sums, records decoded once a batch into shared memory, cp.async
// staging, heavy tiles first) replaced a first version that was bound by
// issue slots: one thread a pixel, 45 shuffles and a log1p, two exps and a
// division a pair.
//
// What held the raster-cell mode back: one block of four warps owned a
// whole cell. For every batch of records it swept the batch once per tile
// of the cell, in series, re-reading the tile's v_out, log T and
// final_idx (an expf a pixel) before each sweep and parking each pixel's
// T and colour behind in a global scratch between them. At cell (2, 2) a
// heavy cell's critical path was four tile sweeps on four warps: 5.99 ms
// at the bench's training arguments, 17.6 times its bound, where the tile
// mode takes 1.29 ms for 1.4 times fewer records. And in both modes every
// warp ran the pretest on every record of the batch, also on the records
// whose footprint misses its 16x4 patch, most of them at cells.
//
// Design, on the CUDA cores. The TPU kernel's moment matmuls and MXU
// prefix scan are not carried over: a tensor-core version needs a
// (record, pixel) fragment layout that breaks the per-pixel back-to-front
// dependency of T and the colour behind, and TF32 products would not hold
// the 1e-4 row tolerance without a three-way split of the operands.
//   - A block a tile, also at cells. A cell of G = cell_w cell_h tiles
//     takes G blocks (block b: cell order[b / G], tile b % G), as
//     rasterize_fwd.cu does; each holds its tile's pixel state (T, colour
//     behind, v_out, t_final v_a, final_idx) in registers for the whole
//     sweep and stages and decodes each batch once. Every block of a cell
//     sweeps the same range [start, last), last from the whole cell's
//     final_idx, and writes a row for each record of it: tile 0 into the
//     gradient rows, tile g > 0 into its own (9, pool) slice of a scratch.
//     A second kernel (cell_sum_kernel, eight blocks a cell, a record a
//     thread) adds the slices into the rows, record by record in tile
//     order, over the range tile 0 leaves past the scratch's slices. A record's row is a
//     sum over all of a cell's pixels, which float atomics would make
//     differ from launch to launch; the fixed order keeps two launches
//     bit-equal. (One block of G warp groups a cell, its partials added in
//     shared memory, needs 128 G threads: at the sweep's 81-90 registers a
//     thread one such block fills an SM at (2, 2), and (4, 2) would need
//     1024 threads of 64 registers. A cluster of G blocks adding through
//     distributed shared memory would keep the sweeps in lock step batch
//     by batch.) At cell (1, 1) there is one block a tile, no scratch and
//     no second kernel. Any cell size runs. The scratch holds (G - 1) x 9
//     floats a pool slot: 453 MB at (2, 2) and the bench's 4M pool. (A
//     block a cell for the second pass took 0.40 ms at (2, 2): the heavy
//     cells' records ran through a few blocks.)
//   - Per-warp record lists. After a batch is decoded each warp tests
//     every record against its own 16x4 patch of pixel centres and keeps,
//     in depth order, the records that may reach it: j <= the warp's
//     largest final_idx, and unless the conic is positive definite and
//     its least sigma over the patch's rectangle (found on the rectangle's
//     edges, each a one-dimensional quadratic, when the centre lies
//     outside) exceeds sigma_max by more than the rounding of the
//     sweep's sigma (1e-5 of the terms' magnitude, ~170 ulp), where no
//     pair of the warp can pass the pretest (reach.cuh's may_reach, which
//     rasterize_fwd.cu shares). The sweep walks only the
//     warp's list, back to front, so a record left off changes nothing:
//     every record's sums and every pixel's running state are those of a
//     sweep of the whole batch, and at cell (1, 1) the rows are the tile
//     kernel's bit for bit. The lists are built by ballots, one record a
//     lane, before the sweep; a conic that is not positive definite (the
//     projection can emit one) is always kept.
//   - Two pixels a thread, 128 threads a tile. A warp covers a compact
//     16 x 4 patch as two 8x4 sub-patches and a lane owns the same position
//     in each. A thread adds its pixels' nine terms in registers before any
//     lane exchange.
//   - The sweep takes four list entries a step: first the eight (record,
//     pixel) sigmas of a thread, independent of one another; a pair is kept
//     only if 0 <= sigma <= log(255 o) + a margin, without which alpha
//     cannot reach ALPHA_EPS, so exp runs only for pairs that are all but
//     surely active. One warp-wide OR tells which of the four records
//     reach a lane at all; the others cost the warp nothing more.
//   - One folded butterfly for all nine terms. Rows 0-7 reduce together:
//     at each of the first three steps a lane sends half of the values it
//     still holds to its partner and adds the half it receives (4 + 2 + 1
//     shuffles), then two plain steps; row 8 takes five: 14 shuffles, not
//     45, in a fixed order. Lanes 0, 4, .., 28 and lane 1 end holding the
//     nine sums and store them with a single store.
//   - Records as a structure, decoded once a batch into 12-float records
//     in shared memory, read as 16-byte broadcast loads; the next batch's
//     packed rows arrive by cp.async while this batch is swept.
//   - Each warp's sums land in its own zero-filled shared buffer,
//     record-major (stride 9, no bank conflicts); after a batch the threads
//     add the four warps' partials in warp order and write each gradient
//     row coalesced over records.
//   - Heavy cells first (tile_order.cuh): the heavy cells' blocks spread
//     over the SMs and the light ones fill in as SMs come free. 192 records
//     a batch make a block 43 KB of shared memory, five blocks an SM (81
//     registers).
//   - Strips (the TPU kernel's tile_ids, rasterize_bwd.py:203): as in
//     rasterize_fwd.cu, a launch's cells are the contiguous run of the
//     image's cells from tile_base; local cell t takes its pixel origin from
//     global cell tile_base + t, everything else stays indexed by t. Cells
//     past the image have starts == ends and return at once. tile_base 0 is
//     the whole-frame kernel, bit for bit.
//   - The TPU kernel's truncated scan (scan_passes < 3 with k_lanes a
//     multiple of 128; scan.cuh) is an instantiation of its own (kPasses,
//     as in rasterize_fwd.cu; 0 is the exact path, its code and bits as
//     they were). The TPU kernel rebuilds log T and the colour behind each
//     batch from suffix sums of m = log1p(-alpha) and of contrib = cw fac,
//     both cut to kPasses bfloat16 parts, and carries the cut batch totals
//     to the batch in front (rasterize_bwd.py:236-252, 345-346). Totals
//     plus suffix sums add, for each record, the cut terms of every
//     record behind it in the cell: one running sum from the back, in
//     another order. So no scan batch enters here (k_lanes is checked and
//     not read), and each pixel carries what the exact path carries: T
//     behind the record t_cur, T before it t_cur / (1 - alpha), T in front
//     of it that times exp(r) = 1 + r, r the rest of m past its parts (a
//     fused multiply-add), and s_behind, which adds the cut contrib. A
//     log1pf an active pair remains, for r, and two terms' parts. On the
//     bench render's inputs (an NVIDIA H100 80GB HBM3 at 700 W,
//     scripts/torch_kernel_variants.py, in turns; PERF.md §6, row 3):
//     1.296 ms at k_lanes 128 against 1.800 for the first version (the
//     batch's end log T and colour behind and both cut sums in the log
//     domain, a log1pf and an expf a pair; 91 registers, 90 now, five
//     blocks an SM either way) and the exact path's 1.056; 1.124 without
//     the log1pf (timing only).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, row 3;
// scripts/torch_kernel_variants.py, the last version in the same process):
// at the bench's training arguments at 4M 1.06 ms against 1.30, 7.6 times
// the bound, the rows bit-equal to the last version's; at cell (2, 2) on
// the bench render's inputs 1.47-1.49 against 5.97-6.00, of which
// cell_sum_kernel takes 0.10. The lists save 1.10 ms at (2, 2) and 0.23 at
// (1, 1).
// The TPU kernel's cell knobs (k_lanes VMEM budget, tiles_per_step shrink,
// raster_vjp.py:154-168) are Mosaic scoped-VMEM limits and have no
// counterpart here. No atomics on floats: every sum has a fixed order, so
// two launches are bit-equal (the tile order's integer atomics move no
// result). Sigma and the colour decode use the forward's explicitly
// rounded intrinsics and the same expf, so the active set is the
// forward's and matches the PyTorch version's.

#include <cuda_runtime.h>

#include "reach.cuh"
#include "scan.cuh"
#include "tile_order.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kPix = 2;                   // pixels a thread
constexpr int kUnroll = 4;                // records a step of the sweep
constexpr int kThreads = kPixels / kPix;  // threads a tile
constexpr int kWarps = kThreads / 32;
constexpr int kPatchH = 2 * kPix;         // rows of a warp's 16-wide patch
constexpr int kBatch = 192;   // records staged per batch (see the header)
constexpr int kRows = 9;      // gradient rows
constexpr int kRawRows = 7;   // packed rows the sweep reads (row 7: ids)
constexpr int kRecFloats = 12;  // x y cxx cxy | cyy sigma_max o r | g b - -
constexpr int kSumThreads = 256;  // cell_sum_kernel: threads a block
constexpr int kSumSplit = 8;      // and blocks a cell
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaEps = static_cast<float>(1.0 / 255.0);
constexpr float kColorLo = -4.0f;
constexpr float kColorStep = static_cast<float>(1.0 / (65535.0 / 8.0));
constexpr float kOpacStep = static_cast<float>(1.0 / 65535.0);
constexpr float kSigmaMargin = 1e-4f;  // see the decode

static_assert(kPix == 2 || kPix == 4 || kPix == 8, "pixels a thread");
static_assert(kUnroll * kPix <= 32, "one bit a pair in a step");
static_assert(kBatch <= 256, "list entries are bytes");

__device__ __forceinline__ float decode_color(unsigned q) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), kColorStep), kColorLo);
}

// Pixel q of a thread lies (q % 2) * 8 right of and (q / 2) * 4 below its
// pixel 0; centres are half-integers far below 2^23, so the sums are exact.
__device__ __forceinline__ float pixel_x(float px0, int q) {
  return px0 + static_cast<float>((q & 1) * 8);
}

__device__ __forceinline__ float pixel_y(float py0, int q) {
  return py0 + static_cast<float>((q >> 1) * 4);
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

// Sums g[0..8] over the warp's 32 lanes in a fixed order. Returns, in
// every lane l, row (l >> 2)'s sum, and row 8's sum in *row8.
__device__ __forceinline__ float folded_sum(const float (&g)[kRows],
                                            unsigned lane, float* row8) {
  const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
  float h[4], k[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows i (lanes 0-15) and 4 + i (16-31)
    const float send = up16 ? g[i] : g[i + 4];
    const float keep = up16 ? g[i + 4] : g[i];
    h[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up8 ? h[i] : h[i + 2];
    const float keep = up8 ? h[i + 2] : h[i];
    k[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  float m = (up4 ? k[1] : k[0]) +
            __shfl_xor_sync(kFull, up4 ? k[0] : k[1], 4);
  m += __shfl_xor_sync(kFull, m, 2);
  m += __shfl_xor_sync(kFull, m, 1);
  float v = g[8];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  *row8 = v;
  return m;
}

// Past the (G - 1) partial slices of the scratch: each cell's end of the
// range its sweep wrote (int), for cell_sum_kernel.
__device__ __forceinline__ int* cell_last(float* partial, int tiles_a_cell,
                                          size_t pool) {
  return reinterpret_cast<int*>(
      partial + static_cast<size_t>(tiles_a_cell - 1) * kRows * pool);
}

// The largest final_idx over the P pixels of cell t, in every thread of
// the block (nthreads threads, a multiple of 32; s_max holds a value a
// warp).
__device__ __forceinline__ int cell_max_fidx(const int* __restrict__ fidx_in,
                                             size_t cell_base, int p,
                                             int nthreads, int* s_max) {
  int m = -1;
  for (int i = threadIdx.x; i < p; i += nthreads) {
    m = max(m, fidx_in[cell_base + i]);
  }
  m = __reduce_max_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = m;
  __syncthreads();
  int tmax = s_max[0];
  for (int w = 1; w < nthreads / 32; ++w) tmax = max(tmax, s_max[w]);
  return tmax;
}

// kPasses > 0: the TPU kernel's truncated scan (scan.cuh: kPasses parts a
// term); 0 compiles the exact path, unchanged by the mode.
template <int kPasses>
__global__ void __launch_bounds__(kThreads)
rasterize_bwd_kernel(const int* __restrict__ packed, int pool,
                     const int* __restrict__ order,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int tile_base,
                     int cells_x, int cell_w, int cell_h,
                     const float* __restrict__ v_out,
                     const float* __restrict__ log_t_in,
                     const int* __restrict__ fidx_in,
                     float* __restrict__ grads,
                     float* __restrict__ partial) {
  __shared__ int s_raw[kRawRows][kBatch];
  __shared__ __align__(16) float s_rec[kBatch][kRecFloats];
  __shared__ __align__(16) float s_part[kWarps][kBatch * kRows];
  __shared__ unsigned char s_list[kWarps][kBatch];
  __shared__ int s_max[kWarps];

  const int tiles_a_cell = cell_w * cell_h;
  const int t = order[blockIdx.x / tiles_a_cell];  // the cell
  const int sub = blockIdx.x % tiles_a_cell;       // this block's tile
  const int gc = tile_base + t;                    // the cell in the image
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int warp = tid >> 5;
  const size_t P = static_cast<size_t>(pool);
  const int start = starts[t];
  const int end = ends[t];
  const int cell_px = kTile * cell_w;  // pixels a cell row
  const size_t cell_base = static_cast<size_t>(t) * kPixels * tiles_a_cell;
  // Tile 0 writes the gradient rows, tile g > 0 its slice of the scratch.
  float* __restrict__ out =
      sub == 0 ? grads : partial + static_cast<size_t>(sub - 1) * kRows * P;

  // Every block of the cell sweeps down from the last record any pixel of
  // the cell composited; tile 0 leaves it for cell_sum_kernel.
  const int last = min(end, cell_max_fidx(fidx_in, cell_base,
                                          kPixels * tiles_a_cell, kThreads,
                                          s_max) + 1);
  if (tiles_a_cell > 1 && sub == 0 && tid == 0) {
    cell_last(partial, tiles_a_cell, P)[t] = max(last, start);
  }
  if (last <= start) return;  // uniform: empty cell or nothing composited

  // Pixel q of this thread: sub-patch warp * kPix + q of the tile (8 wide,
  // 4 high, two to a row of sub-patches), position (lane % 8, lane / 8)
  // inside it; lx, ly from the tile's corner, tx, ty the tile's corner in
  // the image.
  const int lx = lane & 7;
  const int ly = (lane >> 3) + warp * kPatchH;
  const int tx = (gc % cells_x) * cell_px + (sub % cell_w) * kTile;
  const int ty = (gc / cells_x) * kTile * cell_h + (sub / cell_w) * kTile;
  const float px0 = static_cast<float>(tx + lx) + 0.5f;
  const float py0 = static_cast<float>(ty + ly) + 0.5f;
  int fidx[kPix];
  // t_cur: T behind the record swept; s_behind: the colour behind it. In
  // the truncated scan both come from the records' terms cut to kPasses
  // parts (the header says why the scan batches drop out).
  float vr[kPix], vg[kPix], vb[kPix], tfva[kPix], t_cur[kPix], s_behind[kPix];
  int wmax = -1;  // the last record any pixel of the warp composited
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int x = (sub % cell_w) * kTile + lx + (q & 1) * 8;
    const int y = (sub / cell_w) * kTile + ly + (q >> 1) * 4;
    const size_t p = cell_base + static_cast<size_t>(y) * cell_px + x;
    fidx[q] = fidx_in[p];
    vr[q] = v_out[p * 4 + 0];
    vg[q] = v_out[p * 4 + 1];
    vb[q] = v_out[p * 4 + 2];
    const float t_final = expf(log_t_in[p]);
    tfva[q] = t_final * v_out[p * 4 + 3];
    t_cur[q] = t_final;
    s_behind[q] = 0.0f;
    wmax = max(wmax, fidx[q]);
  }
  wmax = __reduce_max_sync(kFull, wmax);
  // The warp's patch of pixel centres.
  const float xa = static_cast<float>(tx) + 0.5f;
  const float xb = xa + static_cast<float>(kTile - 1);
  const float ya = static_cast<float>(ty + warp * kPatchH) + 0.5f;
  const float yb = ya + static_cast<float>(kPatchH - 1);

  // Lane 4r ends a folded sum holding row r (r < 8); lane 1 stores row 8.
  const int my_row = (lane & 3) == 0 ? lane >> 2 : (lane == 1 ? 8 : -1);
  float* part = s_part[warp];
  unsigned char* list = s_list[warp];

  auto stage = [&](int b_start, int count) {
    for (int r = 0; r < kRawRows; ++r) {
      const int* src = packed + r * P + b_start;
      for (int k = tid; k < count; k += kThreads) {
        cp_async4(&s_raw[r][k], src + k);
      }
    }
    cp_async_commit();
  };

  stage(max(start, last - kBatch), last - max(start, last - kBatch));
  for (int b_end = last; b_end > start; b_end -= kBatch) {
    const int b_start = max(start, b_end - kBatch);
    const int count = b_end - b_start;
    cp_async_wait_all();
    __syncthreads();  // the batch has arrived; the last sweep and flush ended
    // A warp stores sums only for the records that reach its pixels.
    for (int i = lane; i < (count * kRows + 3) / 4; i += 32) {
      reinterpret_cast<float4*>(part)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int k = tid; k < count; k += kThreads) {
      const unsigned c0 = static_cast<unsigned>(s_raw[5][k]);
      const unsigned c1 = static_cast<unsigned>(s_raw[6][k]);
      float4* rec = reinterpret_cast<float4*>(s_rec[k]);
      rec[0] = make_float4(__int_as_float(s_raw[0][k]),
                           __int_as_float(s_raw[1][k]),
                           __int_as_float(s_raw[2][k]),
                           __int_as_float(s_raw[3][k]));
      const float o = __fmul_rn(static_cast<float>(c1 >> 16), kOpacStep);
      // alpha >= ALPHA_EPS needs o exp(-sigma) >= 1 / 255: no pair with
      // sigma above log(255 o), and a margin far wider than the rounding
      // of expf and the product, can be active.
      rec[1] = make_float4(__int_as_float(s_raw[4][k]),
                           logf(255.0f * o) + kSigmaMargin, o,
                           decode_color(c0 & 0xFFFFu));
      rec[2] = make_float4(decode_color(c0 >> 16),
                           decode_color(c1 & 0xFFFFu), 0.0f, 0.0f);
    }
    __syncthreads();  // s_rec is whole, s_raw is free
    if (b_start > start) {
      const int n_start = max(start, b_start - kBatch);
      stage(n_start, b_start - n_start);
    }

    // This warp's list: the batch's records that may reach its patch, in
    // depth order, one record a lane.
    int n_list = 0;
    for (int k0 = 0; k0 < count; k0 += 32) {
      const int k = k0 + static_cast<int>(lane);
      bool keep = false;
      if (k < count && b_start + k <= wmax) {
        const float4 ra4 = reinterpret_cast<const float4*>(s_rec[k])[0];
        keep = may_reach(ra4.x, ra4.y, ra4.z, ra4.w, s_rec[k][4],
                         s_rec[k][5], xa, xb, ya, yb);
      }
      const unsigned votes = __ballot_sync(kFull, keep);
      if (keep) {
        list[n_list + __popc(votes & ((1u << lane) - 1u))] =
            static_cast<unsigned char>(k);
      }
      n_list += __popc(votes);
    }
    __syncwarp();

    // The sweep, kUnroll list entries at a time. First every (record,
    // pixel) pair's sigma and its test, independent of one another; then,
    // record by record back to front, the pairs that passed.
    for (int i0 = n_list - 1; i0 >= 0; i0 -= kUnroll) {
      float sigma[kUnroll][kPix];
      int ks[kUnroll];
      unsigned mine = 0;  // bit u * kPix + q: pair (entry i0 - u, pixel q)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ks[u] = list[max(i0 - u, 0)];
        const float4 ra4 = reinterpret_cast<const float4*>(s_rec[ks[u]])[0];
        const float x = ra4.x, y = ra4.y, cxx = ra4.z, cxy = ra4.w;
        const float cyy = s_rec[ks[u]][4];
        const float sigma_max = s_rec[ks[u]][5];
        const int j = b_start + ks[u];
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const float dx = __fsub_rn(x, pixel_x(px0, q));
          const float dy = __fsub_rn(y, pixel_y(py0, q));
          const float quad = __fadd_rn(__fmul_rn(__fmul_rn(cxx, dx), dx),
                                       __fmul_rn(__fmul_rn(cyy, dy), dy));
          sigma[u][q] = __fadd_rn(__fmul_rn(0.5f, quad),
                                  __fmul_rn(__fmul_rn(cxy, dx), dy));
          const bool maybe = i0 - u >= 0 && j <= fidx[q] &&
                             sigma[u][q] >= 0.0f && sigma[u][q] <= sigma_max;
          mine |= static_cast<unsigned>(maybe) << (u * kPix + q);
        }
      }
      const unsigned warps = __reduce_or_sync(kFull, mine);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 - u < 0) break;
        const int k = ks[u];
        if ((warps >> (u * kPix)) & ((1u << kPix) - 1u)) {  // warp-uniform
          const float4* rec = reinterpret_cast<const float4*>(s_rec[k]);
          const float4 ra4 = rec[0], rb4 = rec[1], rc4 = rec[2];
          const float x = ra4.x, y = ra4.y, cxx = ra4.z, cxy = ra4.w;
          const float cyy = rb4.x, o = rb4.z;
          const float cr = rb4.w, cg = rc4.x, cb = rc4.y;
          float g[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) g[r] = 0.0f;
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            if (!((mine >> (u * kPix + q)) & 1u)) continue;
            const float vis = expf(-sigma[u][q]);
            const float alpha = fminf(kAlphaMax, __fmul_rn(o, vis));
            if (alpha < kAlphaEps) continue;
            const float dx = __fsub_rn(x, pixel_x(px0, q));
            const float dy = __fsub_rn(y, pixel_y(py0, q));
            const float ra = __fdividef(1.0f, 1.0f - alpha);
            const float cw = cr * vr[q] + cg * vg[q] + cb * vb[q];
            const float t_before = t_cur[q] * ra;
            const float fac = alpha * t_before;
            const float v_alpha = cw * t_before + ra * (tfva[q] - s_behind[q]);
            if constexpr (kPasses > 0) {
              // The record's terms cut to kPasses parts: the colour's
              // added, and T in front of the record is T before it times
              // exp(rest) of log1p(-alpha) (rasterize_bwd.py:236-252).
              s_behind[q] = __fadd_rn(
                  s_behind[q], scan_term<kPasses>(__fmul_rn(cw, fac)));
              t_cur[q] = times_exp<kPasses>(
                  t_before, scan_rest<kPasses>(log1pf(-alpha)));
            } else {
              s_behind[q] += cw * fac;
              t_cur[q] = t_before;
            }
            const float vs = -o * vis * v_alpha;
            const float vx = vs * dx, vy = vs * dy;
            g[0] += cxx * vx + cxy * vy;
            g[1] += cxy * vx + cyy * vy;
            g[2] += 0.5f * vx * dx;
            g[3] += vx * dy;
            g[4] += 0.5f * vy * dy;
            g[5] += fac * vr[q];
            g[6] += fac * vg[q];
            g[7] += fac * vb[q];
            g[8] += vis * v_alpha;
          }
          float m8;
          const float m = folded_sum(g, lane, &m8);
          if (my_row >= 0) part[k * kRows + my_row] = lane == 1 ? m8 : m;
        }
      }
    }
    __syncthreads();
    // Add the warps' partials of every (row, record) in warp order.
    for (int r = 0; r < kRows; ++r) {
      for (int k = tid; k < count; k += kThreads) {
        float acc = s_part[0][k * kRows + r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += s_part[w][k * kRows + r];
        out[r * P + static_cast<size_t>(b_start + k)] = acc;
      }
    }
  }
}

// Cells of several tiles: each record's row is tile 0's (in grads) plus
// the other tiles' partial rows, added in tile order. kSumSplit blocks a
// cell over the range the sweep wrote, a record a thread, its nine rows'
// loads in flight together.
__global__ void __launch_bounds__(kSumThreads)
cell_sum_kernel(int pool, const int* __restrict__ starts, int tiles_a_cell,
                float* __restrict__ grads, float* __restrict__ partial) {
  const int t = blockIdx.x / kSumSplit;
  const size_t P = static_cast<size_t>(pool);
  const int last = cell_last(partial, tiles_a_cell, P)[t];
  for (int j = starts[t] + (blockIdx.x % kSumSplit) * kSumThreads +
               threadIdx.x;
       j < last; j += kSumSplit * kSumThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = grads[r * P + j];
    for (int g = 1; g < tiles_a_cell; ++g) {
      const float* src = partial + static_cast<size_t>(g - 1) * kRows * P + j;
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = src[r * P];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += v[r];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) grads[r * P + j] = acc[r];
  }
}

// The sweep at passes (0: the exact scan).
decltype(&rasterize_bwd_kernel<0>) kernel_of(int passes) {
  return passes == 1   ? &rasterize_bwd_kernel<1>
         : passes == 2 ? &rasterize_bwd_kernel<2>
                       : &rasterize_bwd_kernel<0>;
}

}  // namespace

// num_cells cells of cell_w x cell_h tiles, cells_x a row; (1, 1) for
// tiles. Local cell t is the image's cell tile_base + t (a strip; 0 for the
// whole frame). passes 0: the exact scan; 1 or 2: the truncated scan of
// that many bfloat16 parts over batches of k_lanes slots (a multiple of
// 128; checked, though the sums do not depend on it). order: num_cells
// ints of scratch; partial: with G = cell_w cell_h > 1 tiles a cell,
// (G - 1) x 9 x pool floats and then num_cells ints of scratch (unread at
// (1, 1)).
extern "C" int rasterize_bwd_launch(const int* packed, int pool,
                                    const int* starts, const int* ends,
                                    int num_cells, int tile_base,
                                    int cells_x, int cell_w, int cell_h,
                                    int passes, int k_lanes,
                                    const float* v_out, const float* log_t,
                                    const int* fidx, float* grads, int* order,
                                    float* partial, void* stream) {
  if (num_cells <= 0) return 0;
  const long long blocks = static_cast<long long>(num_cells) * cell_w * cell_h;
  if (cell_w < 1 || cell_h < 1 || tile_base < 0 || blocks > 0x7FFFFFFFLL ||
      static_cast<long long>(num_cells) * kSumSplit > 0x7FFFFFFFLL ||
      static_cast<long long>(tile_base) + num_cells > 0x7FFFFFFFLL ||
      passes < 0 || passes > 2 ||
      (passes > 0 && (k_lanes < kLaneAlign || k_lanes % kLaneAlign))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(starts, ends, num_cells,
                                                order);
  kernel_of(passes)<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      packed, pool, order, starts, ends, tile_base, cells_x, cell_w, cell_h,
      v_out, log_t, fidx, grads, partial);
  if (cell_w * cell_h > 1) {
    cell_sum_kernel<<<num_cells * kSumSplit, kSumThreads, 0, s>>>(
        pool, starts, cell_w * cell_h, grads, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

// The compiled sweep at passes (0: the exact scan): out[0] its registers a
// thread, out[1] its local memory a thread in bytes (spills), out[2] the
// blocks an SM can hold.
extern "C" int rasterize_bwd_attrs(int passes, int* out) {
  const void* fn = reinterpret_cast<const void*>(kernel_of(passes));
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fn, kThreads, 0));
}
