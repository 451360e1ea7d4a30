// Expand depth-ordered splats into per-intersection records (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/expand.py, expand_pallas (:374) and its
// body _make_expand_kernel (:210) — the TPU kernel gathers each slot's
// splat with a one-hot MXU matmul over bf16-split component rows.
//
// What it computes: producing splat w (depth order) owns the pool slots
// [cum[w-1], cum[w]). Slot s < total gets
//   key  = tile id: for a small splat (bbox <= 8x8) the rank-th set bit of
//          its 64-bit coverage mask on the fixed 8x8 layout, else the
//          row-major rank inside its bbox (rank = s - cum[w-1]);
//   rec  = the 8-row packed record: bitcast x, y, cxx, cxy, cyy; colop0;
//          colop1; the compact splat id w.
// Slots >= total get key num_tiles, rows 0-6 = 0 and row 7 = n.
//
// Bound on the H100: bytes. Each slot reads ~44 bytes of its owner's
// fields (cached: consecutive slots share owners) and writes 36 bytes; a
// few dozen integer ops per slot are far below the card's rate.
//
// Design: one thread per pool slot. The owner comes from a binary search
// over the inclusive count cumsum — the same ownership test
// offs[w] <= s < cum[w] the TPU kernel builds from its one-hot window — so
// there is no per-splat write loop and every store is coalesced by slot.
// The thread writes every slot of the pool, sentinels included, because the
// wrapper allocates the outputs uninitialised.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ f5, const int* __restrict__ u5,
              const int* __restrict__ cum, const int* __restrict__ total_p,
              int n, int pool, int tiles_x, int num_tiles,
              int* __restrict__ keys, int* __restrict__ recs) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= pool) return;
  const size_t P = static_cast<size_t>(pool);
  const size_t N = static_cast<size_t>(n);
  const int total = *total_p;

  if (s >= total) {
    keys[s] = num_tiles;
    for (int r = 0; r < kRows - 1; ++r) recs[r * P + s] = 0;
    recs[(kRows - 1) * P + s] = n;
    return;
  }

  // First w with cum[w] > s: total <= cum[n-1], so it exists.
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] > s) hi = mid; else lo = mid + 1;
  }
  const int w = lo;
  const int rank = s - (w > 0 ? cum[w - 1] : 0);

  // Decode row 0 (render.pack_decode_parts): tmin_x (10b) | small << 10 |
  // tmin_y << 11 (11b) | bbox_w << 22. Unsigned, so shifts are logical.
  const unsigned d0 = static_cast<unsigned>(u5[2 * N + w]);
  const int tmin_x = static_cast<int>(d0 & 0x3FFu);
  const bool small = (d0 >> 10) & 1u;
  const int tmin_y = static_cast<int>((d0 >> 11) & 0x7FFu);
  const int bbox_w = static_cast<int>(d0 >> 22);

  int dx, dy;
  if (small) {
    // rank-th set bit of the 64-bit mask (m_lo bits 0-31, m_hi 32-63).
    const unsigned m_lo = static_cast<unsigned>(u5[3 * N + w]);
    const unsigned m_hi = static_cast<unsigned>(u5[4 * N + w]);
    const int pc_lo = __popc(m_lo);
    const bool in_hi = rank >= pc_lo;
    unsigned word = in_hi ? m_hi : m_lo;
    const int r = in_hi ? rank - pc_lo : rank;
    for (int i = 0; i < r; ++i) word &= word - 1u;  // drop r lowest bits
    const int pos = (in_hi ? 32 : 0) + __ffs(word) - 1;
    dy = pos >> 3;
    dx = pos & 7;
  } else {
    const int bw = bbox_w > 1 ? bbox_w : 1;
    dy = rank / bw;
    dx = rank - dy * bw;
  }
  keys[s] = (tmin_y + dy) * tiles_x + tmin_x + dx;

  // "+ 0.0f" turns -0.0 into +0.0, as the TPU kernel's matmul gather does.
  for (int r = 0; r < 5; ++r)
    recs[r * P + s] = __float_as_int(f5[r * N + w] + 0.0f);
  recs[5 * P + s] = u5[w];
  recs[6 * P + s] = u5[N + w];
  recs[7 * P + s] = w;
}

}  // namespace

extern "C" int expand_launch(const float* f5, const int* u5, const int* cum,
                             const int* total, int n, int pool, int tiles_x,
                             int num_tiles, int* keys, int* recs,
                             void* stream) {
  if (pool <= 0) return 0;
  const int blocks = (pool + kThreads - 1) / kThreads;
  expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f5, u5, cum, total, n, pool, tiles_x, num_tiles, keys, recs);
  return static_cast<int>(cudaGetLastError());
}
