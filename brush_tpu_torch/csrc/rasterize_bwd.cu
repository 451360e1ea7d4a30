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
// written. That bound counts lanes, not warps: in the
// bench scene about 8 % of the pairs are active, and a warp pays for 32
// lanes whenever one is. It also counts exp and the reciprocal at the
// float32 rate.
//
// What held the first version back: one thread a pixel, and for every
// (warp, record) with an active lane nine five-step xor reductions (45
// shuffles, 45 adds, nine lone shared stores), nine scalar shared loads a
// record from nine arrays, a log1p, two exps and a division a pair, the
// per-record loop overhead repeated by 256 threads, eight warps' partials
// through 36 KB of shared memory, records staged by plain loads between
// two barriers. It was bound by issue slots on the few SMs that
// held the heavy tiles: a tile's sweep is serial, all tiles started at
// once in index order, and an SM that drew several heavy tiles ran long after
// one that drew none had gone idle.
//
// Design, on the CUDA cores. The TPU kernel's moment matmuls and MXU
// prefix scan are not carried over: a tensor-core version needs a
// (record, pixel) fragment layout that breaks the per-pixel back-to-front
// dependency of T and the colour behind, and TF32 products would not hold
// the 1e-4 row tolerance without a three-way split of the operands.
//   - Two pixels a thread, 128 threads a tile. A warp covers a compact
//     16 x 4 patch as two 8x4 sub-patches and a lane owns the same position
//     in each, so a small splat activates few sub-patches. A thread adds
//     its pixels' nine terms in registers before any lane exchange. (Four
//     and eight pixels a thread measured slower: with few heavy tiles an
//     SM, the warps they take away are missed more than the exchanges
//     they save.)
//   - The sweep takes four records a step. First the eight (record, pixel)
//     sigmas of a thread, independent of one another, so one warp keeps
//     the pipeline full; a pair is kept only if sigma <= log(255 o) + a
//     margin, without which alpha cannot reach ALPHA_EPS, so exp runs only
//     for pairs that are all but surely active. One warp-wide OR tells
//     which of the four records reach the warp at all; the others cost
//     the warp nothing more, not even a store.
//   - One folded butterfly for all nine terms. Rows 0-7 reduce together:
//     at each of the first three steps a lane sends half of the values it
//     still holds to its partner and adds the half it receives (4 + 2 + 1
//     shuffles), then two plain steps; row 8 takes five: 14 shuffles, not
//     45, in a fixed order. Lanes 0, 4, .., 28 and lane 1 end holding the
//     nine sums and store them with a single store.
//   - Records as a structure. Each batch is decoded once into 12-float
//     records in shared memory, read as 16-byte broadcast loads.
//   - Asynchronous staging. The next batch's packed rows arrive by
//     cp.async while this batch is swept; decode happens on arrival.
//   - Each warp's sums land in its own zero-filled shared buffer,
//     record-major (stride 9, no bank conflicts); after a batch the threads
//     add the four warps' partials in warp order and write each gradient
//     row coalesced over records.
//   - Heavy tiles first. A one-block kernel (tile_order.cuh) orders the
//     tiles by record count, and block b sweeps tile
//     order[b]: the heavy tiles spread round-robin over the SMs and the
//     light ones fill in as SMs come free. 192 records a batch make a block
//     42 KB of shared memory, five blocks an SM, which measured best:
//     fewer resident blocks leave more tiles to be handed out late.
//   - Raster cells (the TPU kernel's cell=(gw, gh) mode, rasterize_bwd.py
//     :76,449). A record's row is a sum over all P pixels of its cell, so
//     one block owns a cell: splitting a cell over blocks that met in float
//     atomics would make two launches differ. The block sweeps each batch
//     of records once for each 16x16 tile of the cell, in a fixed order;
//     a warp's sums for a record add up over the tiles in its shared
//     buffer (the first tile stores, the later ones add), and the flush
//     adds the warps in warp order as before. A pixel's transmittance and
//     colour behind carry from one batch to the next; with several tiles a
//     cell they wait in a global scratch buffer (2 floats a pixel, written
//     and read by the thread that owns the pixel) between a tile's sweeps,
//     and its inputs (v_out, log T, final_idx) are read again for each
//     sweep. The block shape stays fixed, so any cell size runs (kPix is 2,
//     4 or 8 and cannot carry a cell's pixels). At cell (1, 1) the state
//     stays in registers and every sum is the tile kernel's, bit for bit.
//     The TPU kernel's cell knobs (k_lanes VMEM budget, tiles_per_step
//     shrink, raster_vjp.py:154-168) are Mosaic scoped-VMEM limits and have
//     no counterpart here.
// No atomics on floats: each record belongs to one tile and every sum has
// a fixed order, so two launches are bit-equal (the tile order's integer
// atomics move no result). Sigma and the colour decode use the forward's
// explicitly rounded intrinsics and the same expf, so the active set is
// the forward's and matches the PyTorch version's.

#include <cuda_runtime.h>

#include "tile_order.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kPix = 2;                   // pixels a thread
constexpr int kUnroll = 4;                // records a step of the sweep
constexpr int kThreads = kPixels / kPix;  // threads a tile
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 192;   // records staged per batch (see the header)
constexpr int kRows = 9;      // gradient rows
constexpr int kRawRows = 7;   // packed rows the sweep reads (row 7: ids)
constexpr int kRecFloats = 12;  // x y cxx cxy | cyy sigma_max o r | g b - -
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr float kAlphaMax = static_cast<float>(0.999);
constexpr float kAlphaEps = static_cast<float>(1.0 / 255.0);
constexpr float kColorLo = -4.0f;
constexpr float kColorStep = static_cast<float>(1.0 / (65535.0 / 8.0));
constexpr float kOpacStep = static_cast<float>(1.0 / 65535.0);
constexpr float kSigmaMargin = 1e-4f;  // see the decode

static_assert(kPix == 2 || kPix == 4 || kPix == 8, "pixels a thread");
static_assert(kUnroll * kPix <= 32, "one bit a pair in a step");

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

__global__ void __launch_bounds__(kThreads)
rasterize_bwd_kernel(const int* __restrict__ packed, int pool,
                     const int* __restrict__ order,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int num_cells,
                     int cells_x, int cell_w, int cell_h,
                     const float* __restrict__ v_out,
                     const float* __restrict__ log_t_in,
                     const int* __restrict__ fidx_in,
                     float* __restrict__ grads,
                     float* __restrict__ state) {
  __shared__ int s_raw[kRawRows][kBatch];
  __shared__ __align__(16) float s_rec[kBatch][kRecFloats];
  __shared__ __align__(16) float s_part[kWarps][kBatch * kRows];
  __shared__ int s_max[kWarps];

  const int t = order[blockIdx.x];  // the cell
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int warp = tid >> 5;
  const size_t P = static_cast<size_t>(pool);
  const int start = starts[t];
  const int end = ends[t];
  const int tiles_a_cell = cell_w * cell_h;
  const int cell_px = kTile * cell_w;  // pixels a cell row
  const size_t cell_base = static_cast<size_t>(t) * kPixels * tiles_a_cell;
  // Pixels of all cells, the stride between the scratch's two rows.
  const size_t all_px = static_cast<size_t>(num_cells) * kPixels * tiles_a_cell;

  // Pixel q of this thread in tile `sub` of the cell: sub-patch
  // warp * kPix + q (8 wide, 4 high, two to a row of sub-patches),
  // position (lane % 8, lane / 8) inside it; lx, ly from the tile's corner.
  const int lx = lane & 7;
  const int ly = (lane >> 3) + warp * (kPix / 2) * 4;
  auto pixel_index = [&](int sub, int q) {
    const int x = (sub % cell_w) * kTile + lx + (q & 1) * 8;
    const int y = (sub / cell_w) * kTile + ly + (q >> 1) * 4;
    return cell_base + static_cast<size_t>(y) * cell_px + x;
  };

  // The last record any pixel of the cell composited.
  int wmax = -1;
  for (int sub = 0; sub < tiles_a_cell; ++sub) {
#pragma unroll
    for (int q = 0; q < kPix; ++q) wmax = max(wmax, fidx_in[pixel_index(sub, q)]);
  }
  wmax = __reduce_max_sync(kFull, wmax);
  if (lane == 0) s_max[warp] = wmax;
  __syncthreads();
  int tmax = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) tmax = max(tmax, s_max[w]);
  const int last = min(end, tmax + 1);
  if (last <= start) return;  // uniform: empty cell or nothing composited

  float px0 = 0.0f, py0 = 0.0f;
  int fidx[kPix];
  float vr[kPix], vg[kPix], vb[kPix], tfva[kPix], t_cur[kPix], s_behind[kPix];
  // This thread's pixels of tile `sub`, and the last record any pixel of
  // the warp composited there; `first`: T and the colour behind start
  // (else they come from the scratch).
  auto load_pixels = [&](int sub, bool first) {
    px0 = static_cast<float>((t % cells_x) * cell_px + (sub % cell_w) * kTile +
                             lx) + 0.5f;
    py0 = static_cast<float>((t / cells_x) * kTile * cell_h +
                             (sub / cell_w) * kTile + ly) + 0.5f;
    wmax = -1;
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const size_t p = pixel_index(sub, q);
      fidx[q] = fidx_in[p];
      vr[q] = v_out[p * 4 + 0];
      vg[q] = v_out[p * 4 + 1];
      vb[q] = v_out[p * 4 + 2];
      const float t_final = expf(log_t_in[p]);
      tfva[q] = t_final * v_out[p * 4 + 3];
      t_cur[q] = first ? t_final : state[p];  // T behind the record swept
      s_behind[q] = first ? 0.0f : state[all_px + p];
      wmax = max(wmax, fidx[q]);
    }
    wmax = __reduce_max_sync(kFull, wmax);
  };
  auto save_pixels = [&](int sub) {
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const size_t p = pixel_index(sub, q);
      state[p] = t_cur[q];
      state[all_px + p] = s_behind[q];
    }
  };
  if (tiles_a_cell == 1) load_pixels(0, true);  // kept in registers

  // Lane 4r ends a folded sum holding row r (r < 8); lane 1 stores row 8.
  const int my_row = (lane & 3) == 0 ? lane >> 2 : (lane == 1 ? 8 : -1);
  float* part = s_part[warp];

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

    for (int sub = 0; sub < tiles_a_cell; ++sub) {
      if (tiles_a_cell > 1) load_pixels(sub, b_end == last);
      // The sweep, kUnroll records at a time. First every (record, pixel)
      // pair's sigma and its test, independent of one another; then,
      // record by record back to front, the pairs that passed.
      for (int k0 = count - 1; k0 >= 0; k0 -= kUnroll) {
        float sigma[kUnroll][kPix];
        unsigned mine = 0;  // bit u * kPix + q: pair (record k0 - u, pixel q)
        if (b_start + k0 - (kUnroll - 1) <= wmax) {  // warp-uniform
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float4* rec =
                reinterpret_cast<const float4*>(s_rec[max(k0 - u, 0)]);
            const float4 ra4 = rec[0];
            const float x = ra4.x, y = ra4.y, cxx = ra4.z, cxy = ra4.w;
            const float cyy = s_rec[max(k0 - u, 0)][4];
            const float sigma_max = s_rec[max(k0 - u, 0)][5];
            const int j = b_start + k0 - u;
#pragma unroll
            for (int q = 0; q < kPix; ++q) {
              const float dx = __fsub_rn(x, pixel_x(px0, q));
              const float dy = __fsub_rn(y, pixel_y(py0, q));
              const float quad = __fadd_rn(__fmul_rn(__fmul_rn(cxx, dx), dx),
                                           __fmul_rn(__fmul_rn(cyy, dy), dy));
              sigma[u][q] = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(cxy, dx), dy));
              const bool maybe = k0 - u >= 0 && j <= fidx[q] &&
                                 sigma[u][q] >= 0.0f &&
                                 sigma[u][q] <= sigma_max;
              mine |= static_cast<unsigned>(maybe) << (u * kPix + q);
            }
          }
        }
        const unsigned warps = __reduce_or_sync(kFull, mine);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 - u;
          if (k < 0) break;
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
              const float t_before = t_cur[q] * ra;
              const float fac = alpha * t_before;
              const float cw = cr * vr[q] + cg * vg[q] + cb * vb[q];
              const float v_alpha =
                  cw * t_before + ra * (tfva[q] - s_behind[q]);
              s_behind[q] += cw * fac;
              t_cur[q] = t_before;
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
            if (my_row >= 0) {
              const float v = lane == 1 ? m8 : m;
              float& slot = part[k * kRows + my_row];
              slot = sub == 0 ? v : slot + v;  // the tiles in a fixed order
            }
          }
        }
      }
      if (tiles_a_cell > 1 && b_start > start) save_pixels(sub);
    }
    __syncthreads();
    // Add the warps' partials of every (row, record) in warp order.
    for (int r = 0; r < kRows; ++r) {
      for (int k = tid; k < count; k += kThreads) {
        float acc = s_part[0][k * kRows + r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += s_part[w][k * kRows + r];
        grads[r * P + static_cast<size_t>(b_start + k)] = acc;
      }
    }
  }
}

}  // namespace

// num_cells cells of cell_w x cell_h tiles, cells_x a row; (1, 1) for
// tiles. order: num_cells ints of scratch; state: with several tiles a
// cell, 2 floats of scratch a pixel of the image (unread at (1, 1)).
extern "C" int rasterize_bwd_launch(const int* packed, int pool,
                                    const int* starts, const int* ends,
                                    int num_cells, int cells_x, int cell_w,
                                    int cell_h, const float* v_out,
                                    const float* log_t, const int* fidx,
                                    float* grads, int* order, float* state,
                                    void* stream) {
  if (num_cells <= 0) return 0;
  if (cell_w < 1 || cell_h < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  tile_order_kernel<<<1, kOrderThreads, 0, s>>>(starts, ends, num_cells,
                                                order);
  rasterize_bwd_kernel<<<num_cells, kThreads, 0, s>>>(
      packed, pool, order, starts, ends, num_cells, cells_x, cell_w, cell_h,
      v_out, log_t, fidx, grads, state);
  return static_cast<int>(cudaGetLastError());
}
