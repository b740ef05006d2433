// Correction's tag fold, two launches a chunk.
//
// The JAX package turns one chunk's row walks into tag counts with device
// scans that XLA compiles into a few fused loops
// (mecat_tpu/ops/consensus_banded.py): the window write, one lax.scan over
// segments (:228-253, scan at :249); the side-band chains, one
// lax.associative_scan (_segmented, :256-263); and the fold, an int8
// one-hot matmul of the presence buffer (:368-385).  The port's plain
// versions run them as Python loops of small torch ops, hundreds of
// launches a chunk, and fold through an int32 presence buffer of 80 words
// a pair and column.  Here they are two kernels:
//
//   * fold_planes (entry mecat_fold_planes) replaces the window write, the
//     placement around the seed and the side-band application of
//     banded_global_planes (:266-344), with the lead GAP marks of
//     _planes_from_rowinfo (:200-225); plain version
//     ops/consensus_banded.banded_global_planes_plain;
//   * fold_tags (entry mecat_fold_tags) replaces banded_presence and the
//     fold and cov_diff of banded_accumulate_tags (:347-392); plain version
//     ops/consensus_banded.fold_tags_plain.
//
// What bounds them on an H100.  Both move bytes and do little arithmetic:
// the planes kernel reads the deposit cells that last write an output
// column (9 bytes a cell of [2G, B, LP] at most) and writes 9 bytes a cell
// of [B, L_t]; the fold reads those 9 bytes a live cell and adds into the
// present cells of counts, one or two of the 80 a column.  At a cns chunk
// (B = 128, L_t 8,192) that is a few MB, microseconds at 3.35 TB/s, so
// each kernel is held back by the latency of its few dependent loads and
// by the requests it makes: a pair's side arrays are [G, B], a segment a
// 32-byte sector; the fold makes an atomic request a present cell, while
// a column's present cells share one or two sectors of its 320-byte
// record.
//
//   * fold_planes, a block of 256 threads a (pair, tile of 1,024 columns),
//     several blocks an SM.  The window write is "last writer wins in
//     segment order", and the placement puts the right direction over the
//     left, so the value of an output column is found, not replayed: the
//     right window if it covers the column, else the left one (flipped),
//     and in that direction's window the highest segment whose clamped
//     window holds the column; that segment's deposit value (GAP below its
//     lead, the masked empties -1 / 0 / 0 where it is not ok), or the
//     empties where no segment holds it.  Two warps read the pair's side
//     arrays once a block (a lane a segment, with the seed) and list, by
//     ballots in segment order, the few segments of each direction whose
//     clamped windows meet the tile, and file the side-band entries; after
//     one barrier each thread walks both lists once for all 4 of its
//     columns (a block apart, so a warp's loads and stores fall on
//     adjacent columns) and starts every deposit load before it uses one.
//     Each warp then runs the side-band entries whose cell is one of its
//     own columns, in order, as the associative scan defines them: an
//     entry's base is the placed value of its cell, fetched by a shuffle
//     from the lane that loaded it (the inputs, before any write, which is
//     what the reference's functional update reads); a group's sum
//     replaces that column's value before the store, so each element is
//     written once.  A cell outside [LG, LG + L_t) of the reference's
//     buffer is cut off by its final slice, so no tile takes its group.
//   * fold_tags, a thread a (pair, column): the column's three planes
//     loaded together, then atomic adds of 1 on its present cells of
//     counts[t_slot] and of +-1 on cov_diff.  Integer atomics are exact in
//     any order, so no presence buffer and no int32 temporary.  A kept
//     pair whose t_slot lies outside [0, T) traps, where the plain
//     version's index_add_ raises (on the CPU) or asserts (on CUDA); a
//     masked pair reads nothing past pair_ok and touches nothing.
//
// Every output element of fold_planes is written; fold_tags updates its
// tables in place.  Both launch on the caller's stream and allocate
// nothing.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kMaxD = 15;           // constants.MAX_INS_DELTA
constexpr int kCells = 5 * (kMaxD + 1);  // counts cells a column: [D1, 5]
constexpr int kGap = 4;             // ops/consensus.GAP
constexpr uint32_t kPackMask = (1u << (2 * kMaxD)) - 1;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 227 * 1024;

// planes: a block of kPlanesThreads a (pair, tile of kPlanesTile columns),
// kPlanesCols columns a thread, kPlanesThreads apart
constexpr int kPlanesThreads = 256;
constexpr int kPlanesCols = 4;
constexpr int kPlanesTile = kPlanesThreads * kPlanesCols;

// fold: a block of kFoldThreads a (pair, tile of kFoldThreads columns), a
// thread a column
constexpr int kFoldThreads = 256;

// int32 arithmetic that wraps as torch's and XLA's int32 tensors do
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t clamp_to(int32_t v, int32_t lo,
                                            int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

constexpr unsigned kFull = 0xffffffffu;

// A planes block's lists in shared memory: for each direction the
// segments whose clamped windows meet the tile, in segment order (window
// start, 2 g + ok, lead); the pair's side-band entries by index (cell,
// pack, count: 0 where its segment is not ok).  Entry k in global column
// order: left segment G_l - 1 - k for k < G_l, then right segment k - G_l.
struct Lists {
  int32_t *start[2], *g_ok[2], *lead[2];
  int32_t *e_cell, *e_pack, *e_cnt;
};

__device__ __forceinline__ Lists lists_in(int32_t* smem, int G_r, int G_l) {
  const int E = G_r + G_l;
  Lists t;
  t.start[0] = smem;
  t.g_ok[0] = smem + G_r;
  t.lead[0] = smem + 2 * G_r;
  t.start[1] = smem + 3 * G_r;
  t.g_ok[1] = t.start[1] + G_l;
  t.lead[1] = t.start[1] + 2 * G_l;
  t.e_cell = smem + 3 * E;
  t.e_pack = t.e_cell + E;
  t.e_cnt = t.e_pack + E;
  return t;
}

// Shared memory of a planes block: six words a segment.
size_t planes_smem(int G_r, int G_l) {
  return ((size_t)G_r + G_l) * 6 * sizeof(int32_t);
}

// One warp lists one direction (d = 1: the left, its local columns
// flipped): lane g of each round of 32 loads segment g's toff, ok, lead and
// side band (and the left's j_end) once, together with the seed, lists the
// segment if its clamped window [start, start + LP) meets the tile's
// columns [l0, l1) in the direction's local columns, and files its
// side-band entry.  Returns the count of listed segments (in every lane).
__device__ int list_direction(
    const Lists& t, int d, const int32_t* __restrict__ toff,
    const uint8_t* __restrict__ ok, const int32_t* __restrict__ lead,
    const int32_t* __restrict__ bp, const int32_t* __restrict__ bc,
    const int32_t* __restrict__ j_end, const int32_t* __restrict__ tseed,
    int G, int G_l, int B, int b, int LG, int LP, int L_t, int l0, int l1) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    const size_t i = (size_t)(g < G ? g : 0) * B + b;
    int32_t tf = 0, k_ok = 0, ld = 0, pack = 0, cnt = 0, je = 0;
    if (g < G) {   // every load in flight before a use
      tf = toff[i];
      k_ok = ok[i];
      ld = lead[i];
      pack = bp[i];
      cnt = bc[i];
      if (d) je = j_end[i];
    }
    const int32_t ts = tseed[b];
    const int32_t base = wrap_add(LG, ts);
    const int Lb = LG + L_t + LG;
    const int at = d ? clamp_to(ts, 0, Lb - LG) : clamp_to(base, 0, Lb - LG);
    const int x_lo = max(LG + l0 - at, 0), x_hi = min(LG + l1 - 1 - at, LG - 1);
    const int lo = d ? LG - 1 - x_hi : x_lo, hi = d ? LG - 1 - x_lo : x_hi;
    // the left's cell base - 1 - (toff + max(j_end, 0)), the right's
    // base + toff - 1
    const int32_t cell =
        d ? wrap_sub(wrap_add(base, -1), wrap_add(tf, je > 0 ? je : 0))
          : wrap_add(wrap_add(base, tf), -1);
    const int32_t st = clamp_to(tf, 0, LG - LP);
    const bool hit = g < G && x_lo <= x_hi && st <= hi && st + LP > lo;
    const unsigned m = __ballot_sync(kFull, hit);
    if (hit) {
      const int pos = n + __popc(m & ((1u << lane) - 1));
      (d ? t.start[1] : t.start[0])[pos] = st;
      (d ? t.g_ok[1] : t.g_ok[0])[pos] = 2 * g + (k_ok != 0);
      (d ? t.lead[1] : t.lead[0])[pos] = ld;
    }
    n += __popc(m);
    if (g < G) {
      const int k = d ? G_l - 1 - g : G_l + g;
      t.e_cell[k] = cell;
      t.e_pack[k] = pack;
      t.e_cnt[k] = k_ok ? cnt : 0;
    }
  }
  return n;
}

__global__ void __launch_bounds__(kPlanesThreads) fold_planes_kernel(
    const int8_t* __restrict__ v0_r, const int32_t* __restrict__ ip_r,
    const int32_t* __restrict__ ic_r, const int8_t* __restrict__ v0_l,
    const int32_t* __restrict__ ip_l, const int32_t* __restrict__ ic_l,
    const int32_t* __restrict__ toff_r, const uint8_t* __restrict__ ok_r,
    const int32_t* __restrict__ lead_r, const int32_t* __restrict__ bp_r,
    const int32_t* __restrict__ bc_r, const int32_t* __restrict__ toff_l,
    const uint8_t* __restrict__ ok_l, const int32_t* __restrict__ lead_l,
    const int32_t* __restrict__ bp_l, const int32_t* __restrict__ bc_l,
    const int32_t* __restrict__ j_end_l, const int32_t* __restrict__ tseed,
    int8_t* __restrict__ g0, int32_t* __restrict__ gp,
    int32_t* __restrict__ gc, int B, int G_r, int G_l, int LP, int LG,
    int L_t) {
  extern __shared__ int32_t smem[];
  __shared__ int n_seg[2];
  // block x: pair x / tiles, its tile x % tiles (a pair's tiles adjacent)
  const int tiles = (L_t + kPlanesTile - 1) / kPlanesTile;
  const int b = blockIdx.x / tiles;
  const int l0 = (blockIdx.x - b * tiles) * kPlanesTile;
  const int l1 = min(l0 + kPlanesTile, L_t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int E = G_r + G_l;
  const Lists t = lists_in(smem, G_r, G_l);

  // warp 0 lists the right direction, warp 1 the left; each side array is
  // read once a block
  if (warp < 2) {
    const bool d = warp == 1;
    const int n = list_direction(
        t, d, d ? toff_l : toff_r, d ? ok_l : ok_r, d ? lead_l : lead_r,
        d ? bp_l : bp_r, d ? bc_l : bc_r, j_end_l, tseed, d ? G_l : G_r, G_l,
        B, b, LG, LP, L_t, l0, l1);
    if (lane == 0) n_seg[d] = n;
  }
  const int32_t ts = tseed[b];
  const int Lb = LG + L_t + LG;
  const int rs = clamp_to(wrap_add(LG, ts), 0, Lb - LG);
  const int ls = clamp_to(ts, 0, Lb - LG);
  __syncthreads();

  // each column's local column in the direction that places it (right
  // over left, the left flipped), -1 where neither does; its writer is the
  // last listed segment whose window holds it: both lists walked once for
  // all of a thread's columns, alike in every thread
  int u[kPlanesCols], own[kPlanesCols];
  unsigned is_left = 0;
#pragma unroll
  for (int j = 0; j < kPlanesCols; ++j) {
    const int l = l0 + threadIdx.x + j * kPlanesThreads;
    const int r = LG + l - rs, f = LG + l - ls;
    const bool left = (unsigned)r >= (unsigned)LG;
    is_left |= (unsigned)left << j;
    u[j] = l >= l1 ? -1
                   : !left ? r : ((unsigned)f < (unsigned)LG ? LG - 1 - f : -1);
    own[j] = -1;
  }
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int n = n_seg[d];
    const int32_t* starts = d ? t.start[1] : t.start[0];
    for (int k = 0; k < n; ++k) {
      const int st = starts[k];
#pragma unroll
      for (int j = 0; j < kPlanesCols; ++j)
        if (((is_left >> j) & 1) == d && (unsigned)(u[j] - st) < (unsigned)LP)
          own[j] = k;
    }
  }
  // every deposit load of this thread's columns in flight before a use
  int32_t v[kPlanesCols], p[kPlanesCols], c[kPlanesCols];
#pragma unroll
  for (int j = 0; j < kPlanesCols; ++j) {
    const bool left = (is_left >> j) & 1;
    int src = -1;
    bool gap = false;
    if (own[j] >= 0) {
      const int k = own[j];
      const int g_ok = (left ? t.g_ok[1] : t.g_ok[0])[k];
      const int cc = u[j] - (left ? t.start[1] : t.start[0])[k];
      gap = cc < (left ? t.lead[1] : t.lead[0])[k];
      if (g_ok & 1) src = ((g_ok >> 1) * B + b) * LP + cc;   // else: empties
    }
    const bool any = src >= 0;
    const int i = any ? src : 0;
    v[j] = any && !gap ? (left ? v0_l : v0_r)[i] : (any ? kGap : -1);
    p[j] = any ? (left ? ip_l : ip_r)[i] : 0;
    c[j] = any ? (left ? ic_l : ic_r)[i] : 0;
  }

  // the listed entries whose cell is one of this warp's columns, in global
  // column order; each reads the placed planes at its cell from the lane
  // that holds that column, before any write.  A chain groups consecutive
  // entries of one cell; its sum is written at the group's last entry,
  // over the column's value
  int32_t wp[kPlanesCols], wc[kPlanesCols];
  unsigned written = 0;
  uint32_t acc_cnt = 0, acc_pack = 0;
  int32_t prev_cell = 0, prev_gp = 0, prev_base = 0;
  int prev_k = -2;
  const auto flush = [&]() {
    if ((int32_t)acc_cnt <= 0) return;
    const int at = prev_cell - LG - l0;
    if (lane == (at & 31)) {
#pragma unroll
      for (int j = 0; j < kPlanesCols; ++j)
        if (at / kPlanesThreads == j) {
          wp[j] = prev_gp | (int32_t)acc_pack;
          wc[j] = wrap_add(prev_base, (int32_t)acc_cnt);
          written |= 1u << j;
        }
    }
  };
  for (int k0 = 0; k0 < E; k0 += 32) {
    const int k = k0 + lane;
    const int32_t cell = k < E ? t.e_cell[k] : 0;
    const long long at = (long long)cell - LG - l0;   // a column of the tile?
    const bool in = k < E && at >= 0 && at < l1 - l0;
    const int col = in ? (int)at : 0;
    const bool mine = in && ((col % kPlanesThreads) >> 5) == warp;
    const int at_lane = col & 31, at_j = col / kPlanesThreads;
    int32_t ev = -1, egp = 0, ebase = 0;
#pragma unroll
    for (int j = 0; j < kPlanesCols; ++j) {
      const int32_t tv = __shfl_sync(kFull, v[j], at_lane);
      const int32_t tp = __shfl_sync(kFull, p[j], at_lane);
      const int32_t tc = __shfl_sync(kFull, c[j], at_lane);
      if (at_j == j) {
        ev = tv;
        egp = tp;
        ebase = tc;
      }
    }
    unsigned m = __ballot_sync(kFull, mine);
    while (m) {                // the same in every lane
      const int e = __ffs(m) - 1;
      m &= m - 1;
      const int32_t e_cell = __shfl_sync(kFull, cell, e);
      const int ke = k0 + e;
      if (e_cell != prev_cell || ke != prev_k + 1) {
        flush();               // a new group: the last one ends here
        acc_cnt = acc_pack = 0;
      }
      const int32_t base = __shfl_sync(kFull, ebase, e);
      int32_t cnt = t.e_cnt[ke];
      cnt = cnt > 0 && __shfl_sync(kFull, ev, e) >= 0 ? cnt : 0;
      // an unconsumed anchor (the cell's value < 0) is dropped
      const int32_t off = wrap_add(base, (int32_t)acc_cnt);
      const int32_t shift = clamp_to(wrap_add(off, off), 0, 2 * kMaxD);
      if (cnt > 0 && off < kMaxD)
        acc_pack |= ((uint32_t)t.e_pack[ke] << shift) & kPackMask;
      acc_cnt += (uint32_t)cnt;
      prev_cell = e_cell;
      prev_k = ke;
      prev_gp = __shfl_sync(kFull, egp, e);
      prev_base = base;
    }
  }
  flush();                     // the last group

  const size_t row = (size_t)b * L_t;
#pragma unroll
  for (int j = 0; j < kPlanesCols; ++j) {
    const int l = l0 + threadIdx.x + j * kPlanesThreads;
    if (l < l1) {
      const bool w = (written >> j) & 1;
      g0[row + l] = (int8_t)v[j];
      gp[row + l] = w ? wp[j] : p[j];
      gc[row + l] = w ? wc[j] : c[j];
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads) fold_tags_kernel(
    const int8_t* __restrict__ g0, const int32_t* __restrict__ gp,
    const int32_t* __restrict__ gc, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ t_slot, const uint8_t* __restrict__ pair_ok,
    const int32_t* __restrict__ tbeg, const int32_t* __restrict__ tend,
    int32_t* __restrict__ counts, int32_t* __restrict__ cov_diff, int L_t,
    int T) {
  const int b = blockIdx.y;
  if (!pair_ok[b]) return;            // a masked pair touches nothing
  // the kept pair's arrays in flight together
  const int32_t slot = t_slot[b], len = tlen[b], beg = tbeg[b],
                end = tend[b];
  if (slot < 0 || slot >= T) {
    // a kept pair with no table row: stop the grid, as torch's index_add_
    // does on CUDA, so that the next synchronising call raises
    if (blockIdx.x == 0 && threadIdx.x == 0)
      printf("fold_tags: pair %d has t_slot %d outside [0, %d)\n", b, slot,
             T);
    __trap();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int32_t a = clamp_to(beg, 0, L_t);
    const int32_t e = clamp_to(end < len ? end : len, 0, L_t);
    if (e > a) {
      int32_t* cov = cov_diff + (size_t)slot * (L_t + 1);
      atomicAdd(cov + a, 1);
      atomicAdd(cov + e, -1);
    }
  }
  const int l = blockIdx.x * kFoldThreads + threadIdx.x;
  if (l >= (len < L_t ? len : L_t)) return;
  // the column's three planes in flight together: gpack does not wait for
  // gcnt
  const size_t i = (size_t)b * L_t + l;
  const int v = g0[i];
  const int32_t cnt = gc[i];
  const uint32_t pack = (uint32_t)gp[i];
  int32_t* cells = counts + ((size_t)slot * L_t + l) * kCells;
  if (v >= 0 && v <= kGap) atomicAdd(cells + v, 1);
  const int top = cnt < kMaxD ? cnt : kMaxD;
  for (int d = 1; d <= top; ++d)
    atomicAdd(cells + 5 * d + ((pack >> (2 * (d - 1))) & 3), 1);
}

}  // namespace

// Deposit planes v0 int8, ip and ic int32 [G, B, LP] of the right (G_r
// segments) and the left (G_l) direction; each direction's toff, lead,
// bnd_pack, bnd_cnt int32 and ok bool [G, B]; the left's j_end int32
// [G_l, B]; tseed int32 [B].  Outputs g0 int8, gp and gc int32 [B, L_t],
// uninitialised: every element is written.  LP = S + W/2 - 1, LG = L_t +
// LP + S.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without a launch, for an S below 1, a W below 2
// or odd, a negative count, a buffer of 2 LG + L_t columns past int32, or
// a direction's deposit planes of 2^31 cells or more, or more segments
// than one block's shared memory holds.
extern "C" int mecat_fold_planes(
    const void* v0_r, const void* ip_r, const void* ic_r, const void* v0_l,
    const void* ip_l, const void* ic_l, const void* toff_r, const void* ok_r,
    const void* lead_r, const void* bp_r, const void* bc_r,
    const void* toff_l, const void* ok_l, const void* lead_l,
    const void* bp_l, const void* bc_l, const void* j_end_l,
    const void* tseed, void* g0, void* gp, void* gc, int B, int G_r,
    int G_l, int S, int W, int L_t, void* stream) {
  if (S < 1 || W < 2 || W % 2 || B < 0 || G_r < 0 || G_l < 0 || L_t < 0)
    return (int)cudaErrorInvalidValue;
  const long long LP = S + W / 2 - 1;
  const long long LG = L_t + LP + S;
  if (2 * LG + L_t > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || L_t == 0) return 0;
  // deposit cells are addressed with int32 offsets
  if ((long long)(G_r > G_l ? G_r : G_l) * B * LP > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = planes_smem(G_r, G_l);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks =
      (long long)B * ((L_t + kPlanesTile - 1) / kPlanesTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fold_planes_kernel<<<(unsigned)blocks, kPlanesThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(v0_r), static_cast<const int32_t*>(ip_r),
      static_cast<const int32_t*>(ic_r), static_cast<const int8_t*>(v0_l),
      static_cast<const int32_t*>(ip_l), static_cast<const int32_t*>(ic_l),
      static_cast<const int32_t*>(toff_r), static_cast<const uint8_t*>(ok_r),
      static_cast<const int32_t*>(lead_r), static_cast<const int32_t*>(bp_r),
      static_cast<const int32_t*>(bc_r), static_cast<const int32_t*>(toff_l),
      static_cast<const uint8_t*>(ok_l), static_cast<const int32_t*>(lead_l),
      static_cast<const int32_t*>(bp_l), static_cast<const int32_t*>(bc_l),
      static_cast<const int32_t*>(j_end_l),
      static_cast<const int32_t*>(tseed), static_cast<int8_t*>(g0),
      static_cast<int32_t*>(gp), static_cast<int32_t*>(gc), B, G_r, G_l,
      (int)LP, (int)LG, L_t);
  return (int)cudaGetLastError();
}

// Global planes g0 int8, gp and gc int32 [B, L_t]; tlen, t_slot, tbeg,
// tend int32 and pair_ok bool [B]; counts int32 [T, L_t, 16, 5] and
// cov_diff int32 [T, L_t + 1], updated in place; t_slot of a pair with
// pair_ok must lie in [0, T), else the kernel traps and the stream's next
// synchronisation fails.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue, without a launch, for a negative count or a table
// past 2^31 cells.
extern "C" int mecat_fold_tags(const void* g0, const void* gp,
                               const void* gc, const void* tlen,
                               const void* t_slot, const void* pair_ok,
                               const void* tbeg, const void* tend,
                               void* counts, void* cov_diff, int B, int L_t,
                               int T, void* stream) {
  if (B < 0 || L_t < 0 || T < 0 || (long long)T * L_t * kCells > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || L_t == 0) return 0;   // nothing to add
  const dim3 grid((unsigned)((L_t + kFoldThreads - 1) / kFoldThreads),
                  (unsigned)B);
  fold_tags_kernel<<<grid, kFoldThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(g0), static_cast<const int32_t*>(gp),
      static_cast<const int32_t*>(gc), static_cast<const int32_t*>(tlen),
      static_cast<const int32_t*>(t_slot),
      static_cast<const uint8_t*>(pair_ok), static_cast<const int32_t*>(tbeg),
      static_cast<const int32_t*>(tend), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(cov_diff), L_t, T);
  return (int)cudaGetLastError();
}
