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
// the planes kernel reads at most the deposit's planes of both directions
// (9 bytes a cell of [2G, B, LP]) and writes 9 bytes a cell of [B, L_t];
// the fold reads those 9 bytes a cell and adds into the present cells of
// counts, one or two of the 80 a column.  At a cns chunk (B = 128, L_t of
// a few thousand) that is a few MB, microseconds at 3.35 TB/s, so the
// design only has to avoid what the plain versions pay: launches, the
// LG-wide intermediate planes and the presence buffer.
//
//   * fold_planes, one block a pair.  The window write is "last writer
//     wins in segment order", and the placement puts the right direction
//     over the left, so the value of an output column is found, not
//     replayed: the right window if it covers the column, else the left
//     one (flipped), and in that direction's window the highest segment
//     whose clamped window holds the column; that segment's deposit value
//     (GAP below its lead, the masked empties -1 / 0 / 0 where it is not
//     ok), or the empties where no segment holds it.  So each thread
//     writes its columns straight to the output, reading one deposit cell
//     for each, and no LG-wide plane exists.  Then the pair's 2G side-band
//     entries: each thread prepares one (its cell, found as above before
//     any write, which is what the reference's functional update reads),
//     and one thread runs the chains in order, as the associative scan
//     defines them, writing a group's sum at its last entry.  Only output
//     columns are written: a cell outside [LG, LG + L_t) of the reference's
//     buffer is cut off by its final slice, so its group is skipped.
//   * fold_tags, a thread a (pair, column): atomic adds of 1 on the present
//     cells of counts[t_slot] and of +-1 on cov_diff.  Integer atomics are
//     exact in any order, so no presence buffer and no int32 temporary.  A
//     kept pair whose t_slot lies outside [0, T) traps, where the plain
//     version's index_add_ raises (on the CPU) or asserts (on CUDA).
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
constexpr int kThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 227 * 1024;

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

struct Value {
  int32_t v0, pack, cnt;
};

// One direction's deposit planes [G, B, LP] and its segments' window
// starts, ok flags and leads (in shared memory).
struct Direction {
  const int8_t* v0;
  const int32_t* ip;
  const int32_t* ic;
  const int32_t* start;  // toff clamped to [0, LG - LP]
  const int32_t* ok;
  const int32_t* lead;
  int G;

  // The value the window write leaves at local column u of [0, LG).
  __device__ Value at(int u, int b, int B, int LP) const {
    for (int g = G - 1; g >= 0; --g) {
      const int c = u - start[g];
      if ((unsigned)c < (unsigned)LP) {
        if (!ok[g]) return {-1, 0, 0};
        const size_t i = ((size_t)g * B + b) * LP + c;
        return {c < lead[g] ? kGap : (int32_t)v0[i], ip[i], ic[i]};
      }
    }
    return {-1, 0, 0};
  }
};

struct Placement {
  Direction right, left;
  int rs, ls;  // the placements' clamped starts in the reference's buffer
  int LG, LP, B;

  // The value the placements leave at column x of the buffer.
  __device__ Value at(int x, int b) const {
    const int r = x - rs;
    if ((unsigned)r < (unsigned)LG) return right.at(r, b, B, LP);
    const int l = x - ls;
    if ((unsigned)l < (unsigned)LG) return left.at(LG - 1 - l, b, B, LP);
    return {-1, 0, 0};
  }
};

// Shared memory of a planes block: three words a segment of each direction,
// then six words a side-band entry.
size_t planes_smem(int G_r, int G_l) {
  return (size_t)(G_r + G_l) * 9 * sizeof(int32_t);
}

__global__ void __launch_bounds__(kThreads) fold_planes_kernel(
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
  const int b = blockIdx.x;
  const int E = G_r + G_l;
  int32_t* seg = smem;                 // start, ok, lead: right then left
  int32_t* e_cell = smem + 3 * E;      // the side-band entries
  int32_t* e_pack = e_cell + E;
  int32_t* e_cnt = e_pack + E;
  int32_t* e_base = e_cnt + E;
  int32_t* e_live = e_base + E;
  int32_t* e_gp = e_live + E;

  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    const bool right = k < G_r;
    const int g = right ? k : k - G_r;
    const size_t i = (size_t)g * B + b;
    seg[k] = clamp_to(right ? toff_r[i] : toff_l[i], 0, LG - LP);
    seg[E + k] = right ? ok_r[i] : ok_l[i];
    seg[2 * E + k] = right ? lead_r[i] : lead_l[i];
  }
  __syncthreads();

  const int32_t ts = tseed[b];
  const int Lb = LG + L_t + LG;
  Placement pl;
  pl.right = {v0_r, ip_r, ic_r, seg, seg + E, seg + 2 * E, G_r};
  pl.left = {v0_l,          ip_l,          ic_l,
             seg + G_r,     seg + E + G_r, seg + 2 * E + G_r,
             G_l};
  pl.rs = clamp_to(wrap_add(LG, ts), 0, Lb - LG);
  pl.ls = clamp_to(ts, 0, Lb - LG);
  pl.LG = LG;
  pl.LP = LP;
  pl.B = B;

  const size_t row = (size_t)b * L_t;
  for (int l = threadIdx.x; l < L_t; l += blockDim.x) {
    const Value v = pl.at(LG + l, b);
    g0[row + l] = (int8_t)v.v0;
    gp[row + l] = v.pack;
    gc[row + l] = v.cnt;
  }

  // the side-band entries in global column order: left segments
  // descending, then right ascending; each reads the placed planes
  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    int32_t cell, pack, cnt;
    bool ok;
    if (k < G_l) {
      const size_t i = (size_t)(G_l - 1 - k) * B + b;
      const int32_t je = j_end_l[i] > 0 ? j_end_l[i] : 0;
      cell = wrap_sub(wrap_add(wrap_add(LG, ts), -1), wrap_add(toff_l[i], je));
      pack = bp_l[i];
      cnt = bc_l[i];
      ok = ok_l[i];
    } else {
      const size_t i = (size_t)(k - G_l) * B + b;
      cell = wrap_add(wrap_add(wrap_add(LG, ts), toff_r[i]), -1);
      pack = bp_r[i];
      cnt = bc_r[i];
      ok = ok_r[i];
    }
    cnt = ok ? cnt : 0;
    int32_t base = 0, at_gp = 0, live = 0;
    if ((long long)cell - LG >= 0 && (long long)cell - LG < L_t) {
      const Value v = pl.at(cell, b);
      base = v.cnt;
      at_gp = v.pack;
      live = cnt > 0 && v.v0 >= 0;   // an unconsumed anchor: dropped
    }
    // a cell outside the output only ever writes outside it: its group
    // counts nothing
    e_cell[k] = cell;
    e_pack[k] = pack;
    e_cnt[k] = live ? cnt : 0;
    e_base[k] = base;
    e_live[k] = live;
    e_gp[k] = at_gp;
  }
  __syncthreads();   // the columns' writes land before the chains' writes

  if (threadIdx.x == 0) {
    uint32_t acc_cnt = 0, acc_pack = 0;
    for (int k = 0; k < E; ++k) {
      const int32_t cell = e_cell[k];
      if (k == 0 || cell != e_cell[k - 1]) acc_cnt = acc_pack = 0;
      const int32_t off = wrap_add(e_base[k], (int32_t)acc_cnt);
      const int32_t shift = clamp_to(wrap_add(off, off), 0, 2 * kMaxD);
      if (e_live[k] && off < kMaxD)
        acc_pack |= ((uint32_t)e_pack[k] << shift) & kPackMask;
      acc_cnt += (uint32_t)e_cnt[k];
      const bool last = k == E - 1 || e_cell[k + 1] != cell;
      if (last && (int32_t)acc_cnt > 0) {
        // a counting group's cell lies in the output (see above)
        const size_t i = row + (cell - LG);
        gp[i] = e_gp[k] | (int32_t)acc_pack;
        gc[i] = wrap_add(e_base[k], (int32_t)acc_cnt);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) fold_tags_kernel(
    const int8_t* __restrict__ g0, const int32_t* __restrict__ gp,
    const int32_t* __restrict__ gc, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ t_slot, const uint8_t* __restrict__ pair_ok,
    const int32_t* __restrict__ tbeg, const int32_t* __restrict__ tend,
    int32_t* __restrict__ counts, int32_t* __restrict__ cov_diff, int L_t,
    int T) {
  const int b = blockIdx.y;
  if (!pair_ok[b]) return;            // a masked pair touches nothing
  const int32_t slot = t_slot[b];
  if (slot < 0 || slot >= T) {
    // a kept pair with no table row: stop the grid, as torch's index_add_
    // does on CUDA, so that the next synchronising call raises
    if (blockIdx.x == 0 && threadIdx.x == 0)
      printf("fold_tags: pair %d has t_slot %d outside [0, %d)\n", b, slot,
             T);
    __trap();
  }
  const int32_t n = tlen[b] < L_t ? tlen[b] : L_t;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int32_t a = clamp_to(tbeg[b], 0, L_t);
    const int32_t e = clamp_to(tend[b] < tlen[b] ? tend[b] : tlen[b], 0, L_t);
    if (e > a) {
      int32_t* cov = cov_diff + (size_t)slot * (L_t + 1);
      atomicAdd(cov + a, 1);
      atomicAdd(cov + e, -1);
    }
  }
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n) return;
  const size_t i = (size_t)b * L_t + l;
  int32_t* cells = counts + ((size_t)slot * L_t + l) * kCells;
  const int v = g0[i];
  if (v >= 0 && v <= kGap) atomicAdd(cells + v, 1);
  const int32_t cnt = gc[i];
  if (cnt > 0) {
    const uint32_t pack = (uint32_t)gp[i];
    const int top = cnt < kMaxD ? cnt : kMaxD;
    for (int d = 1; d <= top; ++d)
      atomicAdd(cells + 5 * d + ((pack >> (2 * (d - 1))) & 3), 1);
  }
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
// more segments than one block's shared memory holds.
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
  const size_t smem = planes_smem(G_r, G_l);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
  }
  fold_planes_kernel<<<B, kThreads, smem,
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
  const dim3 grid((unsigned)((L_t + kThreads - 1) / kThreads), (unsigned)B);
  fold_tags_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(g0), static_cast<const int32_t*>(gp),
      static_cast<const int32_t*>(gc), static_cast<const int32_t*>(tlen),
      static_cast<const int32_t*>(t_slot),
      static_cast<const uint8_t*>(pair_ok), static_cast<const int32_t*>(tbeg),
      static_cast<const int32_t*>(tend), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(cov_diff), L_t, T);
  return (int)cudaGetLastError();
}
