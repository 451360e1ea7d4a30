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
// kernel takes 0.45 ms on the device (4 times the bound above, 0.11 ms),
// the version without per-warp lists 0.63 and the first version
// 1.95-1.99. The TPU kernel's polynomial sigma on the MXU and its
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
//   - The TPU kernel's truncated scan (its scan_passes < 3 with k_lanes a
//     multiple of 128; scan.cuh), the reference's shipping default, is an
//     instantiation of its own (kPasses, the bfloat16 parts a term keeps,
//     1 or 2; 0 is the exact path, whose code and bits stay as they
//     were). Within each batch of k_lanes pool slots from the cell's start
//     rounded down to 128, the crossing test and each record's T take the
//     prefix sum of its log1p(-alpha) terms cut to kPasses parts; log T
//     carries from batch to batch by the exact terms (rasterize_fwd.py
//     :437-469). As products: a term cut to its parts is the exact term
//     less its rest r (|r| <= 2^-16 of it at two parts), so a pixel carries
//     t_cur, T through this batch's cut terms, and t_exact, T through the
//     exact ones, which t_cur takes at each new batch; T before a record is
//     t_cur (1 - r), after it that times 1 - alpha, a fused multiply-add
//     each, and the pixel stops where that is not above exp of the
//     float32 log(1e-4). A log1pf an active pair remains, for r, and no
//     exp. A batch's end comes from each passing record's pool index (its
//     slot, at cells), not from the staging batches of kBatch records,
//     which start at the cell's start and bear no relation to the TPU
//     kernel's; a record left off a list or failing the pretest moves
//     neither product, so taking t_exact at the next passing record's
//     batch is exact. On the bench render's inputs (the H100 above,
//     in turns; PERF.md §6, row 2): 0.706 ms at k_lanes 128, against 0.838 for the first version (log T
//     in the log domain: a log1pf and a second expf an active pair, scan.cuh
//     's parts in a loop over a runtime count) and the exact path's 0.443.
//     The log1pf sets the pace: 0.487 without it (timing only). A step that
//     handed its counted pairs' log1pf to the warp's lanes in turn, a pair
//     a lane through shared memory, took 0.784: the hand-off cost more
//     than the idle lanes it saved (about a third of a (warp, record)'s
//     lanes count).
//   - The early-out. A pixel that crossed the threshold drops out of the
//     pretest; a warp whose pixels have all crossed skips its sweeps, and
//     the block leaves its loop when no pixel of the tile is live. The
//     crossing record is not composited and nothing behind it is.
//   - Heavy tiles first (4). Block b takes tile order[b] (tile_order.cuh).
//     (Dealing the head of the order to the SMs by %smid evened the
//     records an SM to within 4 % and gained under 2 %: left out.)
//   - Per-warp record lists. After a batch is decoded, each warp tests
//     its records against its own 8x4 patch of pixel centres, one record a
//     lane (reach.cuh's may_reach, the test of rasterize_bwd.cu's lists),
//     and keeps those that may reach it, in depth order, in a list of
//     16-bit batch slots padded to whole steps with a record no pair can
//     pass; the sweep walks the list. A record left off is one whose
//     least sigma over the patch lies above sigma_max plus the rounding
//     margin: no pixel of the warp can pass the pretest with it, so every
//     pixel's state, its crossing and the early-outs are those of a sweep
//     of the whole batch, bit for bit. (Sweeping the whole batch in every
//     warp took 0.63 ms at the bench render's inputs, the lists 0.45.)
//   - Raster cells (the TPU kernel's cell=(gw, gh) mode, rasterize_fwd.py
//     :201-240): one block a 16x16 tile of a cell, cell_w cell_h blocks a
//     cell; block b takes cell order[b / (cell_w cell_h)] (heavy cells
//     first) and its tile b % (cell_w cell_h). Every block stages the whole
//     cell's record range, but most of a cell's records cannot reach a
//     given tile. So at a cell a batch first passes a tile cull: a record
//     a thread, tested against the block's tile by the same rule; only the
//     records that may reach it are decoded into shared memory, in depth
//     order (a round's warps in order, a warp's lanes by ballot), each
//     with its slot in the batch, since final_idx is the record's pool
//     index; the warp lists are then built over the kept records. A block
//     whose tile keeps nothing of a batch still meets the batch's
//     barriers. (Without the cull and the lists every warp of every block
//     swept the whole cell's range: 1.41-1.44 ms at cell (2, 2) on the
//     bench's inputs, 4.5 times the bound.) The pixel origin moves to the
//     tile's place in its cell and the output index counts row-major over
//     the cell; any cell size runs. At cell (1, 1) every record reaches
//     its tile by construction, so the tile kernel (kCells false) has no
//     cull. The TPU kernel's knobs that the cell changes (its k_lanes VMEM
//     budget and the tiles_per_step shrink, raster_vjp.py:154-168) are
//     Mosaic scoped-VMEM limits and have no counterpart here.
//   - Strips (the TPU kernel's tile_ids, rasterize_fwd.py:230-240,
//     :407-408): the num_cells cells of a launch are the contiguous run of
//     the image's cells from tile_base, and local cell t takes its pixel
//     origin from global cell tile_base + t; starts, ends, the heavy-cells-
//     first order and the outputs stay indexed by t. The JAX package only
//     ever passes such runs (parallel/train_step.py:221-222; render.py:176,
//     317 pass arange), so the kernel takes tile_base and a count, not an
//     array of ids. Cells past the image come with starts == ends and are
//     written as any empty cell. tile_base 0 is the whole-frame kernel, bit
//     for bit.
//   - Asynchronous staging (5). The next batch's seven packed rows arrive
//     by cp.async while this batch is swept; decode happens on arrival.
//     384 records a batch (29 KB) measured 2 % faster than 192.
// What is left: the sweep is bound by issue slots. About 19 instructions a
// (warp, record) are the common path (eleven of them sigma's separately
// rounded operations, which the agreement with the PyTorch version and the
// backward forbids to fuse); the lists keep only the (warp, record)s that
// may hold an active lane, though only 8 % of the pairs are active.
// No atomics on floats and no exchange between threads: a pixel's sums are
// one thread's, in depth order, so two launches are bit-equal (the tile
// order's integer atomics move no result). Sigma, the opacity and colour
// decode and alpha use explicitly rounded intrinsics (no fused
// multiply-add) and expf, so each is the value the PyTorch version
// computes op by op and the set of pairs that count is the same there, here
// and in rasterize_bwd.cu.

#include <cuda_runtime.h>

#include "reach.cuh"
#include "scan.cuh"
#include "tile_order.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = kPixels;  // one pixel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;         // records a step of the sweep
constexpr int kBatch = 384;   // records staged per batch (see the header)
constexpr int kRawRows = 7;   // packed rows the sweep reads (row 7: ids)
constexpr int kRecFloats = 12;  // x y cxx cxy | cyy sigma_max o r | g b - -
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaEps = static_cast<float>(1.0 / 255.0);
constexpr float kTEps = 1e-4f;  // TRANSMITTANCE_EPS
// The truncated scan's threshold: the plain version and the TPU kernel
// compare a float32 log T with log(TRANSMITTANCE_EPS) rounded to float
// (-9.2103405); this is exp of that, rounded to float (one ulp under
// 1e-4f), which the running product is compared with.
constexpr float kTEpsScan = 0x1.a36e2cp-14f;
constexpr float kColorLo = -4.0f;
constexpr float kColorStep = static_cast<float>(1.0 / (65535.0 / 8.0));
constexpr float kOpacStep = static_cast<float>(1.0 / 65535.0);
constexpr float kSigmaMargin = 1e-4f;  // see the decode

static_assert(kUnroll <= 32, "one bit a record in a step");
static_assert(kBatch % kUnroll == 0, "a batch is padded to whole steps");
static_assert(kBatch < 65536, "list entries and slots are 16-bit");

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

// The record of batch slot k, decoded: x y cxx cxy | cyy sigma_max o r |
// g b - -, from the packed rows staged in s_raw.
struct Decoded {
  float4 a, b, c;
};

__device__ __forceinline__ Decoded decode_record(const int (*s_raw)[kBatch],
                                                 int k) {
  const unsigned c0 = static_cast<unsigned>(s_raw[5][k]);
  const unsigned c1 = static_cast<unsigned>(s_raw[6][k]);
  const float o = __fmul_rn(static_cast<float>(c1 >> 16), kOpacStep);
  Decoded d;
  d.a = make_float4(__int_as_float(s_raw[0][k]), __int_as_float(s_raw[1][k]),
                    __int_as_float(s_raw[2][k]), __int_as_float(s_raw[3][k]));
  // alpha >= ALPHA_EPS needs o exp(-sigma) >= 1 / 255: no pair with
  // sigma above log(255 o), and a margin far wider than the rounding of
  // expf and the product, can be active (o = 0 gives -inf).
  d.b = make_float4(__int_as_float(s_raw[4][k]),
                    logf(255.0f * o) + kSigmaMargin, o,
                    decode_color(c0 & 0xFFFFu));
  d.c = make_float4(decode_color(c0 >> 16), decode_color(c1 & 0xFFFFu),
                    0.0f, 0.0f);
  return d;
}

__device__ __forceinline__ void store_record(float (*s_rec)[kRecFloats],
                                             int k, const Decoded& d) {
  float4* rec = reinterpret_cast<float4*>(s_rec[k]);
  rec[0] = d.a;
  rec[1] = d.b;
  rec[2] = d.c;
}

// kCells: cells of several tiles (cell_w cell_h > 1); false compiles the
// tile kernel, without the division that maps a block to its cell and
// without the tile cull. kPasses > 0: the TPU kernel's truncated scan
// (scan.cuh, kPasses parts a term, batches of k_lanes slots); 0 compiles
// the exact path, unchanged by the mode. Blocks an SM: four for tiles,
// three at cells (measured on the bench's inputs in turns, device ms: tiles
// 0.446 at
// four, 0.478 at three, 0.484 unbounded at 76 registers; (2, 2) 0.649 at
// three, 0.684 at four, 0.760 unbounded at 98 registers, two blocks;
// (4, 2) 0.829, 0.802, 0.934).
template <bool kCells, int kPasses>
__global__ void __launch_bounds__(kThreads, kCells ? 3 : 4)
rasterize_fwd_kernel(const int* __restrict__ packed, int pool,
                     const int* __restrict__ order,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int tile_base,
                     int cells_x, int cell_w, int cell_h, int k_lanes,
                     float* __restrict__ img,
                     float* __restrict__ log_t_out,
                     int* __restrict__ fidx_out) {
  __shared__ int s_raw[kRawRows][kBatch];
  // Slot kBatch: a record no pair can pass, where lists are padded.
  __shared__ __align__(16) float s_rec[kBatch + 1][kRecFloats];
  // At cells: batch slot of each record kept by the tile cull.
  __shared__ unsigned short s_slot[kCells ? kBatch : 1];
  __shared__ int s_kept[2][kWarps];  // the cull's counts, two rounds
  __shared__ __align__(16) unsigned short s_list[kWarps][kBatch];

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
  // (lx, ly) counts from the corner of the cell, whose place in the image
  // is that of the global cell tile_base + t; (tx, ty) is the tile's
  // corner in the image.
  const int lx = (lane & 7) + (warp & 1) * 8 + (sub % cell_w) * kTile;
  const int ly = (lane >> 3) + (warp >> 1) * 4 + (sub / cell_w) * kTile;
  const int gc = tile_base + t;
  const int tx = (gc % cells_x) * cell_px + (sub % cell_w) * kTile;
  const int ty = (gc / cells_x) * kTile * cell_h + (sub / cell_w) * kTile;
  const float px = static_cast<float>((gc % cells_x) * cell_px + lx) + 0.5f;
  const float py =
      static_cast<float>((gc / cells_x) * kTile * cell_h + ly) + 0.5f;
  // The pixel centres of the tile and of this warp's patch.
  const float tile_xa = static_cast<float>(tx) + 0.5f;
  const float tile_ya = static_cast<float>(ty) + 0.5f;
  const float warp_xa = tile_xa + static_cast<float>((warp & 1) * 8);
  const float warp_ya = tile_ya + static_cast<float>((warp >> 1) * 4);
  unsigned short* list = s_list[warp];

  float t_cur = 1.0f;  // T so far
  // The truncated scan: t_cur is T with this scan batch's terms cut to
  // kPasses parts, t_exact T by the exact terms, which t_cur takes at each
  // new batch (the TPU kernel's carry); scan_end is the slot past this
  // scan batch (warp-uniform: the list is the warp's, in depth order).
  float t_exact = 1.0f;
  const int scan_base = start / kLaneAlign * kLaneAlign;
  int scan_end = -1;
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

  if (tid == 0) {
    store_record(s_rec, kBatch,
                 Decoded{make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                         make_float4(0.0f, __int_as_float(0xff800000), 0.0f,
                                     0.0f),
                         make_float4(0.0f, 0.0f, 0.0f, 0.0f)});
  }
  if (start < end) stage(start, min(kBatch, end - start));
  for (int base = start; base < end; base += kBatch) {
    const int count = min(kBatch, end - base);
    cp_async_wait_all();
    // The batch has arrived and the last sweep ended. The tile is done
    // once none of its pixels is live.
    if (__syncthreads_or(alive) == 0) break;
    int n_rec = count;  // records in s_rec
    if (kCells) {
      // The tile cull: a record a thread; those that may reach the tile
      // are decoded into s_rec in depth order (a round's warps in order,
      // each warp's lanes by ballot), each with its batch slot.
      n_rec = 0;
      for (int k0 = 0, round = 0; k0 < count; k0 += kThreads, ++round) {
        const int k = k0 + tid;
        Decoded d;
        bool keep = false;
        if (k < count) {
          d = decode_record(s_raw, k);
          keep = may_reach(d.a.x, d.a.y, d.a.z, d.a.w, d.b.x, d.b.y,
                           tile_xa, tile_xa + (kTile - 1), tile_ya,
                           tile_ya + (kTile - 1));
        }
        const unsigned votes = __ballot_sync(kFull, keep);
        if (lane == 0) s_kept[round & 1][warp] = __popc(votes);
        __syncthreads();
        int at = n_rec;
        for (int w = 0; w < kWarps; ++w) {
          const int c = s_kept[round & 1][w];
          at += w < warp ? c : 0;
          n_rec += c;
        }
        if (keep) {
          at += __popc(votes & ((1u << lane) - 1u));
          store_record(s_rec, at, d);
          s_slot[at] = static_cast<unsigned short>(k);
        }
      }
    } else {
      for (int k = tid; k < count; k += kThreads) {
        store_record(s_rec, k, decode_record(s_raw, k));
      }
    }
    __syncthreads();  // s_rec is whole, s_raw is free
    if (base + kBatch < end) {
      stage(base + kBatch, min(kBatch, end - base - kBatch));
    }
    if (!warp_live) continue;  // warp-uniform

    // This warp's list: the records that may reach its patch, in depth
    // order, one record a lane, padded to whole steps with slot kBatch.
    int n_list = 0;
    for (int k0 = 0; k0 < n_rec; k0 += 32) {
      const int k = k0 + static_cast<int>(lane);
      bool keep = false;
      if (k < n_rec) {
        const float4 ra4 = reinterpret_cast<const float4*>(s_rec[k])[0];
        keep = may_reach(ra4.x, ra4.y, ra4.z, ra4.w, s_rec[k][4],
                         s_rec[k][5], warp_xa, warp_xa + 7.0f, warp_ya,
                         warp_ya + 3.0f);
      }
      const unsigned votes = __ballot_sync(kFull, keep);
      if (keep) {
        list[n_list + __popc(votes & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(k);
      }
      n_list += __popc(votes);
    }
    const int n_steps = (n_list + kUnroll - 1) / kUnroll * kUnroll;
    if (n_list + static_cast<int>(lane) < n_steps) {
      list[n_list + lane] = static_cast<unsigned short>(kBatch);
    }
    __syncwarp();

    // The sweep, kUnroll records at a time. First every record's sigma
    // and its test, independent of one another; then, record by record
    // front to back, those that passed.
    for (int i0 = 0; i0 < n_steps; i0 += kUnroll) {
      int ks[kUnroll];
      if constexpr (kUnroll == 8) {  // one 16-byte load
        const uint4 e = *reinterpret_cast<const uint4*>(&list[i0]);
        const unsigned w4[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ks[u] = (w4[u >> 1] >> ((u & 1) * 16)) & 0xFFFFu;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) ks[u] = list[i0 + u];
      }
      float sigma[kUnroll];
      unsigned mine = 0;  // bit u: record ks[u] passed for this pixel
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 ra4 = *reinterpret_cast<const float4*>(s_rec[ks[u]]);
        const float2 rb2 =
            *reinterpret_cast<const float2*>(&s_rec[ks[u]][4]);
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
        const int k = ks[u];
        const int j = base + (kCells ? s_slot[k] : k);
        if constexpr (kPasses > 0) {
          if (j >= scan_end) {  // a new scan batch: the exact T carries
            scan_end = scan_batch_start(j, scan_base, k_lanes) + k_lanes;
            t_cur = t_exact;
          }
        }
        const float2 oc = *reinterpret_cast<const float2*>(&s_rec[k][6]);
        const float2 gb = *reinterpret_cast<const float2*>(&s_rec[k][8]);
        if (!(alive && ((mine >> u) & 1u))) continue;
        const float vis = expf(-sigma[u]);
        const float alpha = fminf(kAlphaMax, __fmul_rn(oc.x, vis));
        if (alpha < kAlphaEps) continue;
        float fac;
        if constexpr (kPasses > 0) {
          // T before the record is the batch's truncated prefix before it
          // plus the record's own exact term, less its truncated term:
          // t_cur exp(-rest); the crossing test takes the prefix after it,
          // that T (1 - alpha) (rasterize_fwd.py:437-469).
          const float before =
              times_exp<kPasses>(t_cur, -scan_rest<kPasses>(log1pf(-alpha)));
          const float after = fmaf(-alpha, before, before);
          if (!(after > kTEpsScan)) {
            alive = false;
            continue;
          }
          fac = alpha * before;
          t_cur = after;
          t_exact = fmaf(-alpha, t_exact, t_exact);
        } else {
          const float after = t_cur * (1.0f - alpha);
          if (after <= kTEps) {
            alive = false;
            continue;
          }
          fac = alpha * t_cur;
          t_cur = after;
        }
        r = fmaf(fac, oc.y, r);
        g = fmaf(fac, gb.x, g);
        b = fmaf(fac, gb.y, b);
        fidx = j;
      }
      warp_live = __any_sync(kFull, alive);
      if (!warp_live) break;
    }
  }

  const size_t p = static_cast<size_t>(t) * kPixels * tiles_a_cell +
                   static_cast<size_t>(ly) * cell_px + lx;
  if constexpr (kPasses > 0) {
    reinterpret_cast<float4*>(img)[p] = make_float4(r, g, b, 1.0f - t_exact);
    log_t_out[p] = logf(t_exact);
  } else {
    reinterpret_cast<float4*>(img)[p] = make_float4(r, g, b, 1.0f - t_cur);
    log_t_out[p] = logf(t_cur);
  }
  fidx_out[p] = fidx;
}

using FwdKernel = decltype(&rasterize_fwd_kernel<false, 0>);

// The instantiation for cells of several tiles (or for tiles) at passes
// (0: the exact scan).
FwdKernel kernel_of(bool cells, int passes) {
  switch (passes) {
    case 1:
      return cells ? &rasterize_fwd_kernel<true, 1>
                   : &rasterize_fwd_kernel<false, 1>;
    case 2:
      return cells ? &rasterize_fwd_kernel<true, 2>
                   : &rasterize_fwd_kernel<false, 2>;
    default:
      return cells ? &rasterize_fwd_kernel<true, 0>
                   : &rasterize_fwd_kernel<false, 0>;
  }
}

}  // namespace

// num_cells cells of cell_w x cell_h tiles, cells_x a row; (1, 1) for
// tiles. Local cell t is the image's cell tile_base + t (a strip; 0 for the
// whole frame). passes 0: the exact scan; 1 or 2: the truncated scan of
// that many bfloat16 parts over batches of k_lanes slots (a multiple of
// 128). order: num_cells ints of scratch.
extern "C" int rasterize_fwd_launch(const int* packed, int pool,
                                    const int* starts, const int* ends,
                                    int num_cells, int tile_base,
                                    int cells_x, int cell_w, int cell_h,
                                    int passes, int k_lanes, float* img,
                                    float* log_t, int* fidx, int* order,
                                    void* stream) {
  if (num_cells <= 0) return 0;
  if (cell_w < 1 || cell_h < 1 || tile_base < 0 ||
      static_cast<long long>(tile_base) + num_cells > 0x7FFFFFFFLL ||
      passes < 0 || passes > 2 ||
      (passes > 0 && (k_lanes < kLaneAlign || k_lanes % kLaneAlign))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(num_cells) * cell_w * cell_h;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(starts, ends, num_cells,
                                                order);
  kernel_of(blocks != num_cells, passes)<<<static_cast<unsigned>(blocks),
                                          kThreads, 0, s>>>(
      packed, pool, order, starts, ends, tile_base, cells_x, cell_w, cell_h,
      k_lanes, img, log_t, fidx);
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel of tiles (cells 0) or cells (1) at passes (0: the
// exact scan): out[0] its registers a thread, out[1] its local memory a
// thread in bytes (spills), out[2] the blocks an SM can hold.
extern "C" int rasterize_fwd_attrs(int cells, int passes, int* out) {
  const void* fn = reinterpret_cast<const void*>(kernel_of(cells, passes));
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], fn, kThreads, 0));
}
