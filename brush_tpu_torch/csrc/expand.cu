// Expand depth-ordered splats into per-intersection records (sm_90a).
//
// Replaces: brush_tpu/ops/pallas/expand.py, expand_pallas (:374) and its
// body _make_expand_kernel (:210) — the TPU kernel gathers each slot's
// splat with a one-hot MXU matmul over bf16-split component rows, one
// window of splats per block of slots.
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
// Bound on the H100: bytes. 36 bytes written per pool slot (the key and 8
// record words), 44 read per splat that owns a live slot (cum and its ten
// field words), 4 for `total`; a few dozen integer operations a slot are
// far below the card's rate. Splats that own no live slot (the padding
// rows the depth order sorts to the end with count 0) are never read.
//
// What held the first version (one thread a slot) back, and what this one
// does about each:
//  1. A binary search over all n rows of cum for every slot (22 dependent
//     loads at n = 4M). Here a block owns kSlots consecutive slots, which
//     touch a contiguous window of owners (kSlots at most when every owner
//     in it has a count >= 1, as the TPU kernel's window), and the whole
//     block finds both ends of the window at once, the owners of its first
//     and last live slot: each round every thread loads one probe of each
//     search and __syncthreads_count narrows each range 257-fold (3 rounds
//     at n = 4M).
//  2. The rank-th set bit came from a loop dropping up to 63 low bits,
//     divergent across a warp. Here it is five branch-free popcount steps
//     on halving windows (the plain version's select_bit64, step for step).
//  3. Every slot gathered its owner's ten words from global memory,
//     although neighbouring slots share owners (2.16 slots a splat at the
//     bench render). Here the window's cum and field words are staged once
//     in shared memory with coalesced loads (its ends known, cum and the
//     fields load together), and each slot finds its owner there (its
//     neighbour's owner or the next one, else a binary search over the
//     window). A chunk holds kChunk = 512 owners (22.5 KB), enough for the
//     bench's 1024 slots of about 474 owners, so six blocks fit an SM
//     (40 registers).
//  4. Nine 4-byte stores a slot, and sentinel slots in the same code as live
//     ones. Here a thread writes its kPer consecutive slots as one 16-byte
//     store per output row where the row is 16-byte aligned (pool % 4 == 0:
//     every pool on the path), scalar stores elsewhere, and a block wholly
//     at or past `total` writes its sentinels and moves on without reading
//     anything but `total`.
// A window wider than kChunk owners (counts of 1, or owners of count 0
// inside a block's live range, which any cum the wrapper accepts may hold)
// is staged chunk by chunk until it reaches the last live slot's owner;
// the kernel never assumes a window's width. As in the plain version, a
// slot past cum[n-1] (total > cum[n-1]) takes owner n - 1.
//
// Measured on one H100 (PERF.md, row 1): the bench render's arguments in
// 0.060 ms, 62 % of the bound. A block lives about 18 us: the search about
// 5, the staging 5 and the stores 8.6, each read phase waiting on memory
// that the other blocks' stores keep busy (the variants script's
// --timeline). Persistent grids, a separate search pass, prefetching the
// next window into L2 during the stores, other block sizes and
// occupancies and streaming stores measured no faster
// (scripts/torch_kernel_variants.py's DEFAULT_VARIANTS).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                      // consecutive slots a thread
constexpr int kSlots = kThreads * kPer;      // slots a block
constexpr int kChunk = kSlots / 2;           // owners staged at once
constexpr int kRows = 8;

struct Window {
  int cum[kChunk + 1];   // cum[wa - 1] (0 at wa = 0), then cum[wa + j]
  float f5[5][kChunk];   // x, y, cxx, cxy, cyy of owner wa + j
  int u5[5][kChunk];     // colop0, colop1, decode row 0, mask_lo, mask_hi
};

// Probe i in [0, kThreads) of a search over [lo, lo + span), span >
// kThreads: the probes cut the range into kThreads + 1 parts.
__device__ __forceinline__ int probe(int lo, int span, int i) {
  return lo + static_cast<int>(static_cast<long long>(i + 1) * span /
                               (kThreads + 1));
}

// For q = 0, 1: the first w in [0, n) with cum[w] > s[q], or n, into
// lo[q]. The whole block searches both at once: each round every thread
// loads one probe of each search (two loads in flight), and
// __syncthreads_count says how many probes lie at or below s[q].
// Invariant: the answer lies in [lo, hi], and hi == n or cum[hi] > s.
__device__ void block_first_above(const int* __restrict__ cum, int n,
                                  const int (&s)[2], int (&lo)[2]) {
  const int t = threadIdx.x;
  int hi[2] = {n, n};
  lo[0] = lo[1] = 0;
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    bool le[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int span = hi[q] - lo[q];
      const bool wide = span > kThreads;
      le[q] = (wide || t < span) &&
              cum[wide ? probe(lo[q], span, t) : lo[q] + t] <= s[q];
    }
    const int c[2] = {__syncthreads_count(le[0]), __syncthreads_count(le[1])};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int span = hi[q] - lo[q];
      if (span > kThreads) {
        const int nlo = c[q] == 0 ? lo[q] : probe(lo[q], span, c[q] - 1) + 1;
        hi[q] = c[q] == kThreads ? hi[q] : probe(lo[q], span, c[q]);
        lo[q] = nlo;
      } else {
        lo[q] = hi[q] = lo[q] + c[q];
      }
    }
  }
}

// First i in [lo, hi) with a[i] > s, else hi - 1; a is nondecreasing and
// lo < hi. The first probe is lo, the common case.
__device__ int first_above(const int* a, int lo, int hi, int s) {
  if (a[lo] > s) return lo;
  int l = lo + 1, h = hi;
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (a[mid] > s) h = mid; else l = mid + 1;
  }
  return l < hi ? l : hi - 1;
}

// Position of the rank-th set bit of the 64-bit mask (lo, hi): the half by
// lo's popcount, then windows of 16, 8, 4, 2 and 1 bits, as
// ops/binning.select_bit64 does (other ranks give the same position too).
__device__ int select_bit64(unsigned lo, unsigned hi, int rank) {
  const int pc_lo = __popc(lo);
  const bool in_hi = rank >= pc_lo;
  const unsigned word = in_hi ? hi : lo;
  int r = in_hi ? rank - pc_lo : rank;
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc((word >> pos) & ((1u << width) - 1u));
    const bool up = r >= c;
    pos += up ? width : 0;
    r -= up ? c : 0;
  }
  return in_hi ? pos + 32 : pos;
}

// The slots base + i with bit i of `mask` set get v[i]: one 16-byte store
// when all kPer are set and the row is aligned, else one store each.
__device__ __forceinline__ void store_row(int* __restrict__ row, int base,
                                          const int (&v)[kPer], unsigned mask,
                                          bool vec) {
  if (vec && mask == (1u << kPer) - 1u) {
    *reinterpret_cast<int4*>(row + base) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if ((mask >> i) & 1u) row[base + i] = v[i];
}

__global__ void __launch_bounds__(kThreads, 6)
expand_kernel(const float* __restrict__ f5, const int* __restrict__ u5,
              const int* __restrict__ cum, const int* __restrict__ total_p,
              int n, int pool, int tiles_x, int num_tiles, bool vec,
              int* __restrict__ keys, int* __restrict__ recs) {
  __shared__ Window win;
  const size_t P = static_cast<size_t>(pool);
  const size_t N = static_cast<size_t>(n);
  const int total = n > 0 ? min(*total_p, pool) : 0;
  const int blocks = (pool + kSlots - 1) / kSlots;

  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int s0 = b * kSlots;
    const int base = s0 + threadIdx.x * kPer;   // this thread's first slot
    const int live_end = min(s0 + kSlots, total);

    // Sentinels: this thread's slots in [total, pool).
    unsigned mask = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      mask |= (base + i >= total && base + i < pool) ? 1u << i : 0u;
    if (mask) {
      const int zero[kPer] = {0, 0, 0, 0};
      const int tiles[kPer] = {num_tiles, num_tiles, num_tiles, num_tiles};
      const int ns[kPer] = {n, n, n, n};
      store_row(keys, base, tiles, mask, vec);
      for (int r = 0; r < kRows - 1; ++r)
        store_row(recs + r * P, base, zero, mask, vec);
      store_row(recs + (kRows - 1) * P, base, ns, mask, vec);
    }
    if (s0 >= total) continue;   // the whole block is sentinels

    // The window: the owners of the block's first and last live slots
    // (n - 1 where no cum exceeds the slot, as in the plain version).
    const int firsts[2] = {s0, live_end - 1};
    int ends[2];
    block_first_above(cum, n, firsts, ends);
    int wa = min(ends[0], n - 1);
    const int w_last = min(ends[1], n - 1);
    int done = s0;   // slots below `done` are written
    for (;;) {
      const int cnt = min(kChunk, w_last + 1 - wa);
      if (threadIdx.x == 0) win.cum[0] = wa > 0 ? cum[wa - 1] : 0;
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        win.cum[1 + j] = cum[wa + j];
#pragma unroll
        for (int r = 0; r < 5; ++r) {
          win.f5[r][j] = f5[r * N + wa + j];
          win.u5[r][j] = u5[r * N + wa + j];
        }
      }
      __syncthreads();
      // Slots in [done, hi_slot) are owned inside this chunk; a chunk that
      // reaches w_last owns every slot left.
      const int hi_slot = wa + cnt > w_last ? INT_MAX : win.cum[cnt];
      const int lo_s = max(base, done);
      const int hi_s = min(base + kPer, min(hi_slot, live_end));
      if (lo_s < hi_s) {
        int own[kPer], rank[kPer];
        unsigned live = 0;
        int j = -1;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int s = base + i;
          if (s >= lo_s && s < hi_s) {
            j = first_above(win.cum + 1, j < 0 ? 0 : j, cnt, s);
            own[i] = j;
            rank[i] = s - win.cum[j];
            live |= 1u << i;
          } else {
            own[i] = 0;
            rank[i] = 0;
          }
        }
        int v[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          // Decode row 0 (render.pack_decode_parts): tmin_x (10b) |
          // small << 10 | tmin_y << 11 (11b) | bbox_w << 22.
          const unsigned d0 = static_cast<unsigned>(win.u5[2][own[i]]);
          const int tmin_x = static_cast<int>(d0 & 0x3FFu);
          const int tmin_y = static_cast<int>((d0 >> 11) & 0x7FFu);
          int dx, dy;
          if ((d0 >> 10) & 1u) {
            const int pos = select_bit64(
                static_cast<unsigned>(win.u5[3][own[i]]),
                static_cast<unsigned>(win.u5[4][own[i]]), rank[i]);
            dy = pos >> 3;
            dx = pos & 7;
          } else {
            const int bw = max(static_cast<int>(d0 >> 22), 1);
            dy = rank[i] / bw;
            dx = rank[i] - dy * bw;
          }
          v[i] = (tmin_y + dy) * tiles_x + tmin_x + dx;
        }
        store_row(keys, base, v, live, vec);
        // "+ 0.0f" turns -0.0 into +0.0, as the TPU kernel's matmul
        // gather does.
#pragma unroll
        for (int r = 0; r < 5; ++r) {
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            v[i] = __float_as_int(win.f5[r][own[i]] + 0.0f);
          store_row(recs + r * P, base, v, live, vec);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) v[i] = win.u5[r][own[i]];
          store_row(recs + (5 + r) * P, base, v, live, vec);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[i] = wa + own[i];
        store_row(recs + (kRows - 1) * P, base, v, live, vec);
      }
      __syncthreads();   // the window is read before it is refilled
      if (hi_slot >= live_end) break;
      done = hi_slot;
      wa += cnt;
    }
  }
}

}  // namespace

extern "C" int expand_launch(const float* f5, const int* u5, const int* cum,
                             const int* total, int n, int pool, int tiles_x,
                             int num_tiles, int* keys, int* recs,
                             void* stream) {
  if (pool <= 0) return 0;
  const bool vec = pool % kPer == 0 &&
                   (reinterpret_cast<uintptr_t>(keys) |
                    reinterpret_cast<uintptr_t>(recs)) % 16 == 0;
  const int blocks = (pool + kSlots - 1) / kSlots;
  expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      f5, u5, cum, total, n, pool, tiles_x, num_tiles, vec, keys, recs);
  return static_cast<int>(cudaGetLastError());
}
