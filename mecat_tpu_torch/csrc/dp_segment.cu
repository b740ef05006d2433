// Banded edit-distance DP segment + local-best endpoint, one warp per lane,
// evaluated as an anti-diagonal wavefront.
//
// Replaces the TPU kernel mecat_tpu/ops/pallas_dp.py:_dp_kernel in both of
// its forms: counts only (dp_segment_best_pallas(..., with_moves=False),
// entry point mecat_dp_segment_best) and move-writing (with_moves=True,
// entry point mecat_dp_segment_best_moves).  It computes exactly what
// mecat_tpu/ops/align.banded_dp_segment followed by pick_end_local compute
// for one S-row segment of every active lane:
//
//   * row i (1..S) covers target cells j in [i - W/2, i + W/2); cells outside
//     [0, tmax] hold VINF = 2^30;
//   * a cell holds the packed value dist * 4096 + indels (IND_K);
//   * row update: cand = min(diag + sub * 4096, vert + 4097), then the
//     horizontal closure cur[w] = min_{u <= w} cand[u] + (w - u) * 4097;
//   * the endpoint is the cell of best score r + j - 4 * dist over rows
//     0..seg_q, ties to the first cell in (row, band) order.  A lane with no
//     valid cell returns (r=0, w=0, v=VINF), the argmax of an all-masked
//     pick_end_local; an inactive lane returns (r=0, w=W/2, v=VINF), the
//     Pallas skip record;
//   * the move-writing form also stores the 2-bit move of every cell of
//     every row it computes: 0 match / 1 mismatch (the value of sub),
//     2 vertical, 3 horizontal, attributed from the same integers as the
//     plain version, valid cell or not: cur == diag ? sub : (cur == vert ?
//     2 : 3), with vert = VINF + 4097 for the last band cell.  16 codes per
//     int32 along the band (cell w in bits 2*(w%16) of word w/16), laid out
//     [B, S, W/16] so a lane's rows are contiguous for the row traceback.
//     The rows it does not compute (see "rows" below) and every row of an
//     inactive lane are written as zeros, so the caller allocates the
//     buffer uninitialised; no traceback reads a row above its r_best.
//
// Band widths: every W with W % 16 == 0 and 16 <= W <= kClusterMaxW =
// 24576, as the reference computes them.  Up to 512 the warp holds Wp =
// 32 * C band cells, C = 2, 4, ..., 16 cells a thread (Wp = 64, 128, ...,
// 512, the least that covers W); the real W comes at run time, except in
// the instances of the paths' widths, 64 and 128, which fix it, so that
// their code folds as a compile-time band allows (a runtime W cost the
// counts loop 12 % and the move kernel 15 % at W = 128 on an H100).  Cells
// w >= W are padding: their target index is pushed out of [0, tmax], so
// every update leaves them at VINF, and the last real cell's vertical input
// is then VINF + 4097 as in the plain version.  They never score and no
// move of theirs is stored.  Where W < Wp every iteration keeps the
// validity select (the fast iterations below need W == Wp).
//
// Past 512 a lane is a block of n = ceil(W / 512) warps ("a wide lane"),
// warp k holding the 512-cell slice [512k, 512k + 512) of the band at
// C = 16 (Wp = 512 n, the cells past W padding as above).  Inside a warp
// the wavefront is the one below; at a warp border the single value that
// crosses a thread border crosses through shared memory: after the even
// step of an iteration each warp's first cell (the vertical input of the
// warp to its left's last cell on the odd step), after the odd step its
// last cell (the horizontal input of the warp to its right's first cell on
// the next even step), each followed by a barrier over the block, which is
// the lane.  Every bound of the iteration loops is the lane's, so the
// lane's warps pass the same barriers and leave together.  Each warp keeps
// the move ring of its slice (288 rows of 128 bytes, 36 KB) and flushes
// the rows its slice has finished on its own schedule; the best cell is
// reduced in each warp, then across the lane's warps through shared
// memory in the same order.  Six move rings (216 KB) and the staging fit
// the block's 227 KB, seven rings (252 KB) do not, so a block holds at most
// kMaxSlices = 6 slices (W <= kMaxW = 3072).  Lanes are handed out by a
// counter to persistent blocks, as many as the card holds at once.
//
// Past 3072 a lane is a thread-block cluster ("a cluster lane") of m =
// ceil(n / 6) blocks of p = ceil(n / m) warps, block r holding slices
// r p .. r p + p - 1 (the m p - n slices past the band's last are padding
// throughout).  It is the wide lane with three changes.  (1) The border
// values of a block's first and last slice cross to the neighbouring block
// through distributed shared memory (a ld.shared::cluster of the
// neighbour's slot, its address taken by mapa once), and every block
// barrier of the lane is a cluster barrier (barrier.cluster.arrive.release
// + wait.acquire), which also orders the slots' writes before the reads.
// (2) Each block stages only the bytes its slices read: the query rows
// 0..S-1 and the framed target from its first cell on, S + 512 p bytes
// (a row i <= S reads target byte i - 1 + w); the reads of the predicated
// iterations, whose cells lie off rows 1..last, are clamped into those
// windows, as their bytes are never used.  (3) Block rank 0 takes the
// lane from the counter and reduces the best cell across the cluster,
// every block's slices in rank order, and each block reads both from rank
// 0's shared memory, so every block runs the same lane to the same
// endpoint, and every bound derived from it is the lane's: the blocks
// pass the same barriers and leave together.  A cluster barrier after each
// reading of rank 0's slots keeps every block, and rank 0 above all, from
// writing them, taking a next lane or exiting while another block can
// still read its shared memory.  Eight blocks are the portable cluster
// size of an H100, so kClusterMaxW = 8 * 3072; past it a lane would need
// more than 8 SMs (a non-portable cluster of 16, or a lane spread over the
// grid).  The persistent grid is as many clusters as the card holds at
// once (cudaOccupancyMaxActiveClusters), launched by cudaLaunchKernelEx.
//
// What bounds it on an H100.  In operations: int32 ALU, 12 per cell (char
// compare, three adds, two mins; for the best cell a shift, a multiply-add,
// a compare and three selects) and 18 with moves (two compares, two
// selects, shift and or), with about 1.2 KB read per lane-segment (S query bytes +
// S+W target bytes at S=512, W=128) and 12 bytes written, plus S*W/4 bytes
// of moves (16 KB); there is no tensor-core form of a min-plus recurrence.
// But the launches the callers make hold 60-900 live lanes, fewer warps
// than the card has schedulers, so what a launch takes is one lane's chain
// of dependent steps, and the design is built to shorten that chain:
//
//   * the closure is the sequential recurrence cur[w] = min(cand[w],
//     cur[w-1] + 4097), value for value: valid cells are contiguous in the
//     band, and an invalid cell can only pass on values above VINF, which
//     the clamp removes.  So cell (i, w) needs (i-1, w) [diagonal],
//     (i-1, w+1) [vertical] and (i, w-1) [horizontal] and nothing else;
//   * cells are made in order of tau = 2*i + w.  The vertical and the
//     horizontal input were made at tau - 1 and the diagonal at tau - 2, so
//     on an even tau all even band cells advance one row at once, on an odd
//     tau all odd ones, each from its own value and its two neighbours as
//     they stand.  No scan, no vote;
//   * a thread holds C adjacent cells in registers.  Only one value
//     crosses a thread border a step: the horizontal input of the thread's
//     first cell (__shfl_up_sync, even tau) or the vertical input of its
//     last (__shfl_down_sync, odd tau).  A step is one shuffle, an add, a
//     three-way min and a select; a lane of r rows takes 2*r + W steps;
//   * the loop counts k = tau / 2.  In iteration k the band's cell pair g
//     (cells 2g, 2g+1) stands on row k - g, so the query and target bytes
//     a thread needs move by one a k: they are kept in registers and one
//     byte of each is read from shared memory per iteration.  Iterations
//     in which some cell of the warp stands outside rows 1..last (the
//     first and the last W/2) run a predicated form of the same body;
//   * rows: a lane computes rows 1..min(seg_q, S, tmax + W/2).  A later row
//     cannot hold the endpoint (rows above seg_q never score, rows above
//     tmax + W/2 have no valid cell), and row i reads only row i-1;
//   * the best cell is tracked per band cell as (score, row, value), with a
//     strict ">" so the earliest row wins (a cell still meets its rows in
//     rising order); one warp reduction on (score desc, r * W + w asc)
//     after the loop.  No packed (score, row) key, so nothing aliases at
//     any S;
//   * moves: byte m of a row holds cell pairs 2m (low nibble) and 2m + 1
//     (high nibble), and pair 2m meets a row one iteration before pair
//     2m + 1.  So in each iteration the thread holding an odd pair joins
//     its nibble with pair 2m's of the iteration before: kept in a register
//     when the thread holds pair 2m too, else fetched from the thread to
//     its left with one __shfl_up_sync (C = 2, 6, 10 and 14), which no DP
//     value waits on.  The byte goes into a ring of move rows in shared
//     memory (W/2 rows are being filled while 32 wait to be written: 128
//     rows up to C = 6, 16 * C + 32 from C = 8 on, 288 at C = 16), and
//     every 32 iterations the warp writes the 32 rows that have become
//     whole, with 16-byte stores where the lane's rows are 16-byte aligned;
//   * lanes are handed out at run time: the grid is two warps for every
//     scheduler of the card, and a warp takes the next lane from a counter
//     until none is left, so the live lanes of a launch spread over the
//     card wherever they lie among the inactive ones (see kResident).
//
// The result is exact.  Both forms of the body also run inside
// extend_kernel (below), which carries a lane's whole segment loop: the
// counts form for the overlap paths (entry mecat_extend_counts), the move
// form for the correction and mapping paths (entry mecat_extend_moves), so
// every path launches once a batch.  Left for later: several lanes per warp
// at W=64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmecat_dp.so dp_segment.cu
// Bound with ctypes by mecat_tpu_torch/ops/dp_kernel.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIndK = 4096;             // ops.align.IND_K
constexpr int kK1 = kIndK + 1;          // one indel step, packed units
constexpr uint32_t kVinf = 1u << 30;    // ops.align.VINF
constexpr int kNeg = -(1 << 26);        // pick_end_local's masked score
constexpr int kTwoPenalty = 4;          // 2 * constants.ALIGN_TRIM_PENALTY
constexpr int kFar = 1 << 30;           // target offset of a padding cell
constexpr int kMinW = 16;               // band widths taken: multiples of 16
constexpr int kSliceW = 512;            //   in [kMinW, kClusterMaxW]; past
constexpr int kMaxSlices = 6;           //   kSliceW a lane takes a warp a
constexpr int kMaxW = kSliceW * kMaxSlices;  // 512-cell slice, at most
                                        //   kMaxSlices a block; past kMaxW
constexpr int kMaxBlocks = 8;           //   a cluster of at most kMaxBlocks
constexpr int kClusterMaxW = kMaxW * kMaxBlocks;  // (the portable size)
constexpr int kWarps = 4;               // warps per block
// Blocks per SM, so warps per scheduler.  On an H100 with 1,024 live lanes
// scattered over 4,096, 2 / 3 / 4 / 6 took 0.075 / 0.104 / 0.134 / 0.181 ms
// (counts, S=512, W=128), and one warp per lane with every block resident
// 0.157: more warps only let live lanes pile up on one scheduler.  With all
// 4,096 live the order turns (0.270 / 0.248 / 0.245 / 0.249, every block
// resident 0.204), but no caller launches that.
constexpr int kResident = 2;
constexpr int kFlush = 32;              // move rows written out at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemDefault = 48 * 1024;  // without an opt-in attribute
constexpr size_t kSmemLimit = 227 * 1024;   // with it
constexpr int kWideHead = 176;          // slots of a wide lane's block
constexpr int kClusterHead = kWideHead + 16;  // and a cluster lane's

// compile-time switch handed to the loop body
template <bool kValue>
struct Flag {
  static constexpr bool value = kValue;
};

__device__ __forceinline__ bool better(int s, int f, int bs, int bf) {
  return s > bs || (s == bs && f < bf);
}

// Band cells a thread holds for a band of W: an even count, so a thread
// holds whole cell pairs.
__host__ __device__ constexpr int cells_for(int W) {
  return 2 * ((W + 63) / 64);
}

// Move rows in a lane's ring: the W/2 rows being filled and the kFlush
// whole ones waiting to be written must fit, and a multiple of kFlush, so
// that a flush never wraps: 128 up to C = 6, then 16 * C + 32 (288 at
// C = 16, 39 KB a lane at S = W = 512 with moves).
__host__ __device__ constexpr int ring_rows(int C) {
  return 32 * C / 2 + kFlush <= 128 ? 128 : 32 * C / 2 + kFlush;
}

// Bytes of shared memory one lane takes: the query with Wp/2 bytes of
// padding on either side, the framed target window with room for the
// padding cells' reads, and with moves the ring.
__host__ __device__ constexpr size_t lane_smem(int S, int W, int C,
                                               bool moves) {
  return 2 * (size_t)(S + 32 * C) +
         (moves ? (size_t)ring_rows(C) * (W / 4) : 0);
}

// n words from a warp's shared memory (16-byte aligned) to dst, by the
// warp: 16-byte stores where dst and n allow them.
__device__ __forceinline__ void copy_words(uint32_t* __restrict__ dst,
                                           const uint8_t* src, const int n,
                                           const int lane) {
  if (((reinterpret_cast<uintptr_t>(dst) & 15) | (n & 3)) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int u = lane; u < n / 4; u += 32) d[u] = s[u];
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (int u = lane; u < n; u += 32) dst[u] = s[u];
  }
}

// `rows` rows of `nw` words from a warp's ring in shared memory (rows
// `src_rb` bytes apart, 16-byte aligned) to dst (rows `dst_rw` words
// apart), by the warp: 16-byte stores where dst, dst_rw and nw allow them.
// A wide lane's warp writes its slice of each row this way.
__device__ __forceinline__ void copy_rows(uint32_t* __restrict__ dst,
                                          const int dst_rw, const uint8_t* src,
                                          const int src_rb, const int nw,
                                          const int rows, const int lane) {
  if (((reinterpret_cast<uintptr_t>(dst) & 15) | (dst_rw & 3) | (nw & 3)) ==
      0) {
    const int nv = nw / 4;
    for (int u = lane; u < rows * nv; u += 32) {
      const int r = u / nv, x = u - r * nv;
      reinterpret_cast<uint4*>(dst + (size_t)r * dst_rw)[x] =
          reinterpret_cast<const uint4*>(src + r * src_rb)[x];
    }
  } else {
    for (int u = lane; u < rows * nw; u += 32) {
      const int r = u / nw, x = u - r * nw;
      dst[(size_t)r * dst_rw + x] =
          reinterpret_cast<const uint32_t*>(src + r * src_rb)[x];
    }
  }
}

// n zero words at dst, by `nt` threads of which this is thread t (a warp
// by default): words up to the first 16-byte boundary, then 16-byte
// stores, then the words left.
__device__ __forceinline__ void zero_words(uint32_t* __restrict__ dst,
                                           const int n, const int t,
                                           const int nt = 32) {
  int head = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4;
  head = min(head, n);
  if (t < head) dst[t] = 0;
  const int nv = (n - head) / 4;
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int u = t; u < nv; u += nt) d[u] = make_uint4(0, 0, 0, 0);
  for (int u = head + 4 * nv + t; u < n; u += nt) dst[u] = 0;
}

// This warp's place in a wide lane (see "Past 512" above): slice k of the
// lane's n, and the shared-memory slots through which the values at the
// warp borders cross, xh[k] (slice k's last cell) and xv[k] (its first).
// In a cluster lane (see "Past 3072") the slots are the block's, indexed by
// the warp's kb of the block's p, and the warp reads its neighbours' at
// shared::cluster addresses, in another block's shared memory at a block
// border.
struct Wide {
  int k = 0;
  int n = 1;
  volatile uint32_t* xh = nullptr;
  volatile uint32_t* xv = nullptr;
  int4* red = nullptr;                  // red[k]: slice k's best (s, f, v)
  int kb = 0;                           // a cluster lane's: the warp in its
  int p = 1;                            //   block, the block's warps, the
  int m = 1;                            //   cluster's blocks and this one's
  int rank = 0;
  uint32_t xh_left = 0;                 // the left slice's xh slot
  uint32_t xv_right = 0;                // the right slice's xv slot
  int y0 = 0;                           // the block's first band cell, where
  int ty = 0;                           //   its target window starts, and the
                                        //   window's bytes
};

// Thread-block clusters: the block's rank, the cluster's blocks, a barrier
// over the cluster (which orders shared-memory writes before it with reads
// after it in every block), and shared::cluster addresses.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// shared memory of block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 const int rank) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(local), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t ld_cluster(const uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ int4 ld_cluster4(const uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The segment of one lane, by one warp, from its staged bytes: `qs` is
// this warp's share of the block's shared memory (see lane_smem), holding
// the query at qs[Wp/2 ..] and the framed target window at qs[S + Wp ..];
// tm and sq are the lane's tmax and seg_q, W its band width (Wp = 32 * C >=
// W > Wp - 64): kW where the instance fixes it (kW = 0: W_rt, at run
// time).  kMoves: also write the lane's move rows, [S, W/16] words at
// mv_out, through `ring`.  kWide: the warp is slice `wide.k` of a wide lane
// (C = 16; `qs` is the lane's staging, Wp = 512 n wide, and `ring` the
// warp's own); every warp of the block must call it with the same lane.
// kCluster: the block is one of a cluster lane's (kWide too; `qs` is the
// block's staging: the query at qs[0 ..], its target window at qs[S ..]);
// every warp of the cluster must call it with the same lane.  Returns the
// endpoint (r, w, packed v) on every thread of the warp (of the lane, for
// a wide or a cluster lane).
template <int C, bool kMoves, int kW, bool kWide = false,
          bool kCluster = false>
__device__ __forceinline__ int3 dp_body(const uint8_t* qs, const int tm,
                                        const int sq, const int S,
                                        const int W_rt, const int lane,
                                        uint8_t* ring,
                                        uint32_t* __restrict__ mv_out,
                                        const Wide wide = Wide{}) {
  static_assert(C % 2 == 0 && C >= 2 && C <= 16,
                "a thread holds whole cell pairs of a band up to 512");
  static_assert(ring_rows(C) % kFlush == 0, "a flush never wraps the ring");
  static_assert(!kWide || (C == 16 && kW == 0),
                "a wide lane's warps hold 512-cell slices");
  static_assert(!kCluster || kWide, "a cluster lane is a wide lane");
  constexpr int Wp = 32 * C;            // band cells a warp holds
  constexpr int P = C / 2;              // cell pairs per thread
  constexpr int kRing = ring_rows(C);
  static_assert(kW == 0 || kW == Wp, "a fixed width fills the band");
  const int W = kW ? kW : W_rt;
  const int half = W / 2;
  const int row_words = W / 16;         // one row of moves
  const int row_bytes = W / 4;
  const int Wq = kWide ? Wp * wide.n : Wp;  // band cells the lane holds
  // qsp[x] = q[x], x in [-Wq/2, S + Wq/2); ts[x] = tpad[x].  A cluster
  // lane's block holds q[0 .. S) and tpad[y0 .. y0 + ty), and a read
  // outside them, which only a cell off rows 1..last makes, is clamped in
  const uint8_t* qsp = kCluster ? qs : qs + Wq / 2;
  const uint8_t* ts = kCluster ? qs + S : qs + S + Wq;
  auto q_at = [&](int x) -> int {
    if constexpr (kCluster) x = min(max(x, 0), S - 1);
    return qsp[x];
  };
  auto t_at = [&](int y) -> int {
    if constexpr (kCluster) y = min(max(y - wide.y0, 0), wide.ty - 1);
    return ts[y];
  };
  const int w0 = (kWide ? wide.k * 32 + lane : lane) * C;
  const int hw0 = w0 / 2;               // the thread's first cell pair
  const bool padded = W < Wq;
  // a wide lane's warp: the bytes of a ring row (its slice's), the slice's
  // first byte of a row of moves, its words in a row and its last real
  // cell pair
  const int ring_rb = kWide ? Wp / 4 : row_bytes;
  const int m0 = kWide ? wide.k * (Wp / 4) : 0;
  const int slice_words = kWide ? min(Wp / 16, row_words - m0 / 4) : 0;
  const int g_hi = kWide ? min(wide.k * (Wp / 2) + Wp / 2 - 1, half - 1) : 0;

  // DP values are unsigned: every legitimate value is below 2^30, and a
  // border input that must not count is pushed above VINF by its addend
  // (up to 2^31 + 4097), which an unsigned min still orders
  uint32_t val[C];
  int best_s[C], best_r[C];
  uint32_t best_v[C];
  // the target index of cell c on row i is i + jo[c]; a padding cell's
  // never lies in [0, tmax], so it stays at VINF
  int jo[C];
  // row 0: val[0][j] = j leading deletions, VINF outside [0, tmax]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w = w0 + c;
    const bool real = kW != 0 || w < W;   // a fixed width has no padding
    jo[c] = real ? w - half : kFar;
    const int j = jo[c];
    const bool valid = j >= 0 && j <= tm;
    val[c] = valid ? (uint32_t)j * kK1 : kVinf;
    const bool ok = valid && sq >= 0;
    // a padding cell loses every tie of the warp reduction
    best_s[c] = ok ? j - kTwoPenalty * (int)(val[c] >> 12)
                   : (real ? kNeg : kNeg - 1);
    best_r[c] = 0;
    best_v[c] = val[c];
  }

  // the last row that can hold the endpoint
  int last = min(min(sq, S), tm + half);
  if (tm < 0 || last < 0) last = 0;

  // one indel step on the value that crosses the thread border; the first
  // band cell has no horizontal input and the last thread's last cell no
  // vertical one (below Wp, the padding cell W gives the last real cell
  // VINF + 4097)
  const bool band_first = lane == 0 && (!kWide || wide.k == 0);
  const bool band_last = lane == 31 && (!kWide || wide.k == wide.n - 1);
  const uint32_t h_add = kK1 + (band_first ? kVinf : 0u);
  const uint32_t v_add = kK1 + (band_last ? kVinf : 0u);
  if constexpr (kCluster) {
    // row 0's last cell of each slice, for the first even step
    if (lane == 31) wide.xh[wide.kb] = val[C - 1];
    cluster_sync();
  } else if constexpr (kWide) {
    // row 0's last cell of each slice, for the first even step
    if (lane == 31) wide.xh[wide.k] = val[C - 1];
    __syncthreads();
  }

  // the bytes of iteration k: qc[p] = q[k - hw0 - 1 - p], the query char of
  // pair p's row; tc[m] = tpad[k + hw0 - 1 + m], the target char of cell m
  // on its pair's row.  Set up as of k = 0 (slot 0 of tc is shifted out);
  // the two new bytes of an iteration are read one iteration ahead.
  int qc[P], tc[P + 1];
#pragma unroll
  for (int p = 0; p < P; ++p) qc[p] = q_at(-hw0 - 1 - p);
  tc[0] = 0;
#pragma unroll
  for (int m = 1; m <= P; ++m) tc[m] = t_at(hw0 - 1 + m);
  int q_next = q_at(-hw0), t_next = t_at(hw0 + P);

  uint32_t prev[P];                     // each pair's nibble one iteration ago
#pragma unroll
  for (int p = 0; p < P; ++p) prev[p] = 0;
  int flushed = 0;                      // move rows written out so far

  // One iteration: an even and an odd step.
  //   kEdge: some cell of the warp may stand outside rows 1..last, so every
  //     update is predicated;
  //   kBorder: some cell may lie outside [0, tmax].  Without it every cell
  //     of the iteration is valid, and then finite (its diagonal input is a
  //     valid cell), so the validity select, the clamp and the VINF test of
  //     the best cell fall away.
  auto iteration = [&](const int k, auto edge, auto border) {
    constexpr bool kEdge = decltype(edge)::value;
    constexpr bool kBorder = decltype(border)::value;
#pragma unroll
    for (int p = P - 1; p > 0; --p) qc[p] = qc[p - 1];
    qc[0] = q_next;
#pragma unroll
    for (int m = 0; m < P; ++m) tc[m] = tc[m + 1];
    tc[P] = t_next;
    q_next = q_at(k - hw0);
    t_next = t_at(k + hw0 + P);

    uint32_t code[C];
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      // the one value that crosses the thread border this step
      uint32_t edge_in = par == 0 ? __shfl_up_sync(kFull, val[C - 1], 1)
                                  : __shfl_down_sync(kFull, val[0], 1);
      if constexpr (kCluster) {
        // at a warp border through shared memory, the cluster's at a
        // block border
        if (par == 0 && lane == 0 && wide.k > 0)
          edge_in = ld_cluster(wide.xh_left);
        if (par == 1 && lane == 31 && wide.k < wide.n - 1)
          edge_in = ld_cluster(wide.xv_right);
      } else if constexpr (kWide) {
        // at a warp border it crosses through shared memory
        if (par == 0 && lane == 0 && wide.k > 0)
          edge_in = wide.xh[wide.k - 1];
        if (par == 1 && lane == 31 && wide.k < wide.n - 1)
          edge_in = wide.xv[wide.k + 1];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = 2 * p + par;
        const int i = k - hw0 - p;
        const uint32_t sub = qc[p] != tc[p + par];
        const uint32_t diag = val[c] + sub * kIndK;
        const uint32_t vert =
            (c + 1 < C) ? val[c + 1] + kK1 : edge_in + v_add;
        const uint32_t hor = (c > 0) ? val[c - 1] + kK1 : edge_in + h_add;
        // a fixed width takes j from its cell's place, as constants fold
        const int j = kW ? i - half + w0 + c : i + jo[c];
        uint32_t cur = min(min(diag, vert), hor);
        if (kBorder) {
          const bool valid = (unsigned)j <= (unsigned)tm;  // tm >= 0 here
          cur = valid ? min(cur, kVinf) : kVinf;
        }
        bool on = true;
        if (kEdge) on = (unsigned)(i - 1) < (unsigned)last;
        if (kMoves) code[c] = cur == diag ? sub : (cur == vert ? 2u : 3u);
        val[c] = on ? cur : val[c];
        const int score = i + j - kTwoPenalty * (int)(cur >> 12);
        if (kBorder) on = on && cur < kVinf;
        if (on && score > best_s[c]) {
          best_s[c] = score;
          best_r[c] = i;
          best_v[c] = cur;
        }
      }
      if constexpr (kCluster) {
        // publish this step's border values, then wait for the cluster
        if (par == 0 && lane == 0) wide.xv[wide.kb] = val[0];
        if (par == 1 && lane == 31) wide.xh[wide.kb] = val[C - 1];
        cluster_sync();
      } else if constexpr (kWide) {
        // publish this step's border values, then wait for the lane's warps
        if (par == 0 && lane == 0) wide.xv[wide.k] = val[0];
        if (par == 1 && lane == 31) wide.xh[wide.k] = val[C - 1];
        __syncthreads();
      }
    }

    if (kMoves) {
      uint32_t nib[P];
#pragma unroll
      for (int p = 0; p < P; ++p) nib[p] = code[2 * p] | (code[2 * p + 1] << 2);
      // pair hw0 - 1's nibble of the iteration before, from the left thread
      uint32_t left = 0;
      if constexpr (P % 2 == 1) left = __shfl_up_sync(kFull, prev[P - 1], 1);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        // an odd pair g completes byte g / 2 of its row k - g
        const bool odd = (P % 2 == 0) ? (p & 1) != 0 : ((lane + p) & 1) != 0;
        if (odd) {
          const int g = hw0 + p;
          const int row = k - g;        // 1-based
          const int m = g >> 1;
          bool mine = kW != 0 || 4 * m < W;
          if (kEdge) mine = mine && (unsigned)(row - 1) < (unsigned)last;
          const uint32_t low = p > 0 ? prev[p > 0 ? p - 1 : 0] : left;
          if (mine)
            ring[((unsigned)(row - 1) % kRing) * ring_rb + m - m0] =
                (uint8_t)(low | (nib[p] << 4));
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) prev[p] = nib[p];
      if constexpr (kWide) {
        // the slice's rows 1..k - g_hi are whole now (none past `last`)
        if (min(k - g_hi, last) - flushed >= kFlush) {
          __syncwarp();
          copy_rows(mv_out + (size_t)flushed * row_words + m0 / 4, row_words,
                    ring + (flushed % kRing) * ring_rb, ring_rb, slice_words,
                    kFlush, lane);
          flushed += kFlush;
          __syncwarp();
        }
      } else if (k - half + 1 - flushed >= kFlush) {
        // rows 1..k - W/2 + 1 are whole now
        __syncwarp();
        copy_words(mv_out + (size_t)flushed * row_words,
                   ring + (flushed % kRing) * row_bytes, kFlush * row_words,
                   lane);
        flushed += kFlush;
        __syncwarp();
      }
    }
  };

  // Iterations 1..last + W/2 - 1.  In [W/2, last] every cell is on a row
  // of the lane; in [W - 1, tmax - W/2 + 1] the rows k - W/2 + 1..k of the
  // iteration also lie inside the target along the whole band, which
  // without padding cells makes every cell valid.
  const int k_end = last > 0 ? last + half - 1 : 0;
  int k = 1;
  for (; k <= min(half - 1, k_end); ++k)
    iteration(k, Flag<true>{}, Flag<true>{});
  for (; k <= min(W - 2, last); ++k)
    iteration(k, Flag<false>{}, Flag<true>{});
  if (!padded) {
#pragma unroll 2
    for (; k <= min(tm - half + 1, last); ++k)
      iteration(k, Flag<false>{}, Flag<false>{});
  }
  for (; k <= last; ++k) iteration(k, Flag<false>{}, Flag<true>{});
  for (; k <= k_end; ++k) iteration(k, Flag<true>{}, Flag<true>{});

  if (kMoves) {
    // the rows still in the ring (fewer than kFlush, contiguous in it), then
    // zeros for the rows never computed
    __syncwarp();
    if constexpr (kWide) {
      copy_rows(mv_out + (size_t)flushed * row_words + m0 / 4, row_words,
                ring + (flushed % kRing) * ring_rb, ring_rb, slice_words,
                last - flushed, lane);
      zero_words(mv_out + (size_t)last * row_words, (S - last) * row_words,
                 wide.k * 32 + lane, 32 * wide.n);
    } else {
      copy_words(mv_out + (size_t)flushed * row_words,
                 ring + (flushed % kRing) * row_bytes,
                 (last - flushed) * row_words, lane);
      zero_words(mv_out + (size_t)last * row_words, (S - last) * row_words,
                 lane);
    }
  }

  // per-thread best, then a warp reduction on (score desc, flat index asc)
  int s = best_s[0], f = best_r[0] * W + w0, v = (int)best_v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const int fc = best_r[c] * W + w0 + c;
    if (better(best_s[c], fc, s, f)) {
      s = best_s[c];
      f = fc;
      v = (int)best_v[c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int so = __shfl_xor_sync(kFull, s, off);
    const int fo = __shfl_xor_sync(kFull, f, off);
    const int vo = __shfl_xor_sync(kFull, v, off);
    if (better(so, fo, s, f)) {
      s = so;
      f = fo;
      v = vo;
    }
  }
  if constexpr (kCluster) {
    // then rank 0 across the cluster, each block's slices in rank order,
    // and every block reads rank 0's result
    if (lane == 0) wide.red[wide.kb] = make_int4(s, f, v, 0);
    cluster_sync();
    int4* res = reinterpret_cast<int4*>(reinterpret_cast<uint8_t*>(wide.red) +
                                        kWideHead);
    if (wide.rank == 0 && threadIdx.x == 0) {
      for (int c = 0; c < wide.m; ++c) {
        const uint32_t red_c = cluster_addr(wide.red, c);
        for (int u = c == 0 ? 1 : 0; u < wide.p; ++u) {
          const int4 o = ld_cluster4(red_c + 16 * u);
          if (better(o.x, o.y, s, f)) {
            s = o.x;
            f = o.y;
            v = o.z;
          }
        }
      }
      *res = make_int4(s, f, v, 0);
    }
    cluster_sync();
    const int4 o = ld_cluster4(cluster_addr(res, 0));
    s = o.x;
    f = o.y;
    v = o.z;
  } else if constexpr (kWide) {
    // then across the lane's warps, in the same order
    if (lane == 0) wide.red[wide.k] = make_int4(s, f, v, 0);
    __syncthreads();
    s = wide.red[0].x;
    f = wide.red[0].y;
    v = wide.red[0].z;
    for (int u = 1; u < wide.n; ++u) {
      const int4 o = wide.red[u];
      if (better(o.x, o.y, s, f)) {
        s = o.x;
        f = o.y;
        v = o.z;
      }
    }
  }
  return make_int3(f / W, f % W, v);  // f >= 0: truncation is floor
}

// The shares of a block's shared memory that warp `warp` takes: its ring
// (rings first: they stay 16-byte aligned whatever S is) and its staging.
template <int C, bool kMoves>
__device__ __forceinline__ void warp_smem(uint8_t* smem, const int warp,
                                          const int S, const int W,
                                          uint8_t** ring, uint8_t** qs) {
  const size_t ring_bytes = kMoves ? (size_t)ring_rows(C) * (W / 4) : 0;
  *ring = smem + (size_t)warp * ring_bytes;
  *qs = smem + (size_t)kWarps * ring_bytes +
        (size_t)warp * 2 * (S + 32 * C);
}

// A wide lane's block: its warps' rings (first: they stay 16-byte aligned),
// then kWideHead bytes of slots (red, xh, xv and the lane counter's word),
// then the lane's staging (the query and the target window, each with
// room for the 512 n band cells).  A cluster lane's block: its warps'
// rings, the same slots and rank 0's reduced best (kClusterHead bytes),
// then the block's staging, S + S + 512 p bytes (see "Past 3072").
static_assert(16 * kMaxSlices <= 96 && 4 * kMaxSlices <= 32,
              "the slots of kWideHead hold kMaxSlices warps");
__host__ __device__ constexpr size_t wide_smem(int S, int n, bool moves) {
  return (moves ? (size_t)n * ring_rows(16) * (kSliceW / 4) : 0) +
         kWideHead + 2 * (size_t)(S + kSliceW * n);
}

template <bool kMoves>
__device__ __forceinline__ void wide_lane_smem(uint8_t* smem, const int S,
                                               Wide* wide, uint8_t** ring,
                                               uint8_t** qs, int** next) {
  const int n = blockDim.x >> 5;
  const int k = threadIdx.x >> 5;
  const size_t ring_bytes =
      kMoves ? (size_t)ring_rows(16) * (kSliceW / 4) : 0;
  uint8_t* head = smem + (size_t)n * ring_bytes;
  *ring = smem + (size_t)k * ring_bytes;
  wide->k = k;
  wide->n = n;
  wide->red = reinterpret_cast<int4*>(head);
  wide->xh = reinterpret_cast<uint32_t*>(head + 96);
  wide->xv = reinterpret_cast<uint32_t*>(head + 128);
  *next = reinterpret_cast<int*>(head + 160);
  *qs = head + kWideHead;
}

// A cluster lane: m blocks of p warps; the target window of block r
// starts at band cell 512 p r.
__host__ __device__ constexpr int cluster_size(int n) {
  return (n + kMaxSlices - 1) / kMaxSlices;
}
__host__ __device__ constexpr int cluster_warps(int n) {
  return (n + cluster_size(n) - 1) / cluster_size(n);
}
__host__ __device__ constexpr size_t cluster_smem(int S, int p, bool moves) {
  return (moves ? (size_t)p * ring_rows(16) * (kSliceW / 4) : 0) +
         kClusterHead + 2 * (size_t)S + (size_t)kSliceW * p;
}

template <bool kMoves>
__device__ __forceinline__ void cluster_lane_smem(uint8_t* smem, const int S,
                                                  Wide* wide, uint8_t** ring,
                                                  uint8_t** qs, int** next) {
  const int p = blockDim.x >> 5;
  const int kb = threadIdx.x >> 5;
  const int rank = cluster_rank();
  const int m = cluster_blocks();
  const size_t ring_bytes =
      kMoves ? (size_t)ring_rows(16) * (kSliceW / 4) : 0;
  uint8_t* head = smem + (size_t)p * ring_bytes;
  *ring = smem + (size_t)kb * ring_bytes;
  wide->kb = kb;
  wide->p = p;
  wide->m = m;
  wide->rank = rank;
  wide->k = rank * p + kb;
  wide->n = m * p;
  wide->red = reinterpret_cast<int4*>(head);
  wide->xh = reinterpret_cast<uint32_t*>(head + 96);
  wide->xv = reinterpret_cast<uint32_t*>(head + 128);
  // the neighbours' slots: this block's, or the next block's at a border
  // (the first and the last slice of the lane read none)
  wide->xh_left = kb > 0 ? cluster_addr((const void*)(wide->xh + kb - 1),
                                        rank)
                         : cluster_addr((const void*)(wide->xh + p - 1),
                                        rank > 0 ? rank - 1 : rank);
  wide->xv_right = kb < p - 1 ? cluster_addr((const void*)(wide->xv + kb + 1),
                                             rank)
                              : cluster_addr((const void*)wide->xv,
                                             rank < m - 1 ? rank + 1 : rank);
  wide->y0 = rank * p * kSliceW;
  wide->ty = S + p * kSliceW;
  *next = reinterpret_cast<int*>(head + 160);
  *qs = head + kClusterHead;
}

// The next lane from the counter, on every thread of the lane's warp (of
// its block, for a wide lane; `slot` is the block's word for it; of the
// cluster, for a cluster lane, from rank 0's word).
template <bool kWide, bool kCluster = false>
__device__ __forceinline__ int take_lane(int32_t* next_lane, int* slot) {
  if constexpr (kCluster) {
    if (threadIdx.x == 0 && cluster_rank() == 0)
      *slot = atomicAdd(next_lane, 1);
    cluster_sync();
    const int b = (int)ld_cluster(cluster_addr(slot, 0));
    cluster_sync();  // read by all before the next lane's write (or exit)
    return b;
  } else if constexpr (kWide) {
    if (threadIdx.x == 0) *slot = atomicAdd(next_lane, 1);
    __syncthreads();
    const int b = *reinterpret_cast<volatile int*>(slot);
    __syncthreads();  // read by all before the next lane's write
    return b;
  } else {
    int b = 0;
    if ((threadIdx.x & 31) == 0) b = atomicAdd(next_lane, 1);
    return __shfl_sync(kFull, b, 0);
  }
}

// Waits for the threads that run one lane: the warp, a wide lane's block
// or a cluster lane's cluster.
template <bool kWide, bool kCluster = false>
__device__ __forceinline__ void lane_sync() {
  if constexpr (kCluster)
    cluster_sync();
  else if constexpr (kWide)
    __syncthreads();
  else
    __syncwarp();
}

// A cluster lane's block stages its windows (see "Past 3072"): the query's
// S bytes from qg and the target's ty bytes from tg + y0, of the S + W
// there, zeros past them; by the block's threads.
__device__ __forceinline__ void cluster_stage(uint8_t* qs, const uint8_t* qg,
                                              const uint8_t* tg, const int S,
                                              const int W, const Wide& wide) {
  uint8_t* ts = qs + S;
  for (int x = threadIdx.x; x < S; x += blockDim.x) qs[x] = qg[x];
  for (int u = threadIdx.x; u < wide.ty; u += blockDim.x) {
    const int y = wide.y0 + u;
    ts[u] = y < S + W ? tg[y] : 0;
  }
}

// One launch lane of the per-segment kernels, by one warp (a wide lane's
// block): stage its q and framed target rows, run the segment, write the
// endpoint (or the skip record of an inactive lane, with zero moves).
// `ring` and `qs` are this warp's shares of the block's shared memory (see
// warp_smem, wide_lane_smem; a cluster lane's block stages its own
// windows, cluster_lane_smem).
template <int C, bool kMoves, int kW, bool kWide, bool kCluster = false>
__device__ __forceinline__ void dp_lane(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ tpad,
    const int32_t* __restrict__ tmax, const int32_t* __restrict__ segq,
    const uint8_t* __restrict__ active, int32_t* __restrict__ r_out,
    int32_t* __restrict__ w_out, int32_t* __restrict__ v_out,
    int32_t* __restrict__ moves_out, const int S, const int W_rt, const int b,
    const int lane, uint8_t* ring, uint8_t* qs, const Wide wide) {
  const int Wp = kWide ? 32 * C * wide.n : 32 * C;  // cells the lane holds
  const int W = kW ? kW : W_rt;
  const int half = W / 2;
  // this thread among the lane's
  const int t = kWide ? wide.k * 32 + lane : lane;
  const int nt = kWide ? 32 * wide.n : 32;

  // this lane's move rows, [S, W/16]
  uint32_t* mv_out =
      kMoves ? reinterpret_cast<uint32_t*>(moves_out) + (size_t)b * S * (W / 16)
             : nullptr;

  if (!active[b]) {
    if (t == 0) {
      r_out[b] = 0;
      w_out[b] = half;
      v_out[b] = (int32_t)kVinf;
    }
    if (kMoves) zero_words(mv_out, S * (W / 16), t, nt);
    return;
  }

  uint8_t* qsp = qs + Wp / 2;
  uint8_t* ts = qs + S + Wp;
  const uint8_t* qg = q + (size_t)b * S;
  const uint8_t* tg = tpad + (size_t)b * (S + W);
  if constexpr (kCluster) {
    cluster_stage(qs, qg, tg, S, W, wide);
  } else if ((S & 15) == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                reinterpret_cast<uintptr_t>(tpad)) & 15) ==
                                   0) {
    // rows and staging are 16-byte aligned
    const uint4* qg4 = reinterpret_cast<const uint4*>(qg);
    const uint4* tg4 = reinterpret_cast<const uint4*>(tg);
    uint4* qs4 = reinterpret_cast<uint4*>(qsp);
    uint4* ts4 = reinterpret_cast<uint4*>(ts);
    for (int x = t; x < S / 16; x += nt) qs4[x] = qg4[x];
    for (int x = t; x < (S + W) / 16; x += nt) ts4[x] = tg4[x];
  } else {
    for (int x = t; x < S; x += nt) qsp[x] = qg[x];
    for (int x = t; x < S + W; x += nt) ts[x] = tg[x];
  }
  lane_sync<kWide, kCluster>();

  const int3 best = dp_body<C, kMoves, kW, kWide, kCluster>(
      qs, tmax[b], segq[b], S, W, lane, ring, mv_out, wide);
  if (t == 0) {
    r_out[b] = best.x;
    w_out[b] = best.y;
    v_out[b] = best.z;
  }
}

// Persistent warps: the grid holds kResident warps for every scheduler of
// the card (or fewer, when the launch has fewer lanes), and each warp takes
// the next lane from a counter until none is left.  A launch with few live
// lanes among many (the callers' usual one) then never stacks live lanes on
// one scheduler while others idle: an inactive lane costs its warp one
// counter round trip, and a scheduler runs at most kResident live lanes at
// a time wherever they lie in the batch.  A wide lane's block takes its
// lanes the same way, every block the card holds at once, and a cluster
// lane's cluster, every cluster the card holds at once.
template <int C, bool kMoves, int kW, bool kWide = false,
          bool kCluster = false>
__global__ void __launch_bounds__(32 * (kWide ? kMaxSlices : kWarps))
dp_segment_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ tpad,
                  const int32_t* __restrict__ tmax,
                  const int32_t* __restrict__ segq,
                  const uint8_t* __restrict__ active,
                  int32_t* __restrict__ r_out, int32_t* __restrict__ w_out,
                  int32_t* __restrict__ v_out,
                  int32_t* __restrict__ moves_out,
                  int32_t* __restrict__ next_lane, int B, int S, int W) {
  extern __shared__ uint4 smem_vec[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t *ring, *qs;
  Wide wide;
  int* slot = nullptr;
  if constexpr (kCluster)
    cluster_lane_smem<kMoves>(reinterpret_cast<uint8_t*>(smem_vec), S,
                              &wide, &ring, &qs, &slot);
  else if constexpr (kWide)
    wide_lane_smem<kMoves>(reinterpret_cast<uint8_t*>(smem_vec), S, &wide,
                           &ring, &qs, &slot);
  else
    warp_smem<C, kMoves>(reinterpret_cast<uint8_t*>(smem_vec), warp, S, W,
                         &ring, &qs);
  for (;;) {
    const int b = take_lane<kWide, kCluster>(next_lane, slot);
    if (b >= B) return;
    dp_lane<C, kMoves, kW, kWide, kCluster>(q, tpad, tmax, segq, active,
                                            r_out, w_out, v_out, moves_out,
                                            S, W, b, lane, ring, qs, wide);
    // the next lane restages this warp's shared memory (a wide lane's
    // block, a cluster lane's cluster, waits in take_lane)
    if constexpr (!kWide) __syncwarp();
  }
}

// The segment loop of one extension direction: every lane run to its end
// in one launch.
//
// Replaces the reference's device loops around seg_step
// (mecat_tpu/ops/align.py:468-514) in _extend_direction_impl: the counts
// form (kMoves false) the jax.lax.while_loop of collect_ops=False at
// :531-541, the move form (kMoves true) the jax.lax.scan of
// collect_ops=True at :520-526, which keeps every segment's moves and
// endpoint.  The port's plain version runs them from the host with one
// sync and some 40-75 small kernels a segment.  Per lane, from qoff = toff
// = dist = matches = alen = nsegs = 0 and active = qlen > 0 & tlen > 0,
// while active and fewer than the lane's max_segs segments have run:
//
//   * seg_q = clamp(qlen - qoff, 0, S), rem_t = clamp(tlen - toff, 0,
//     S + W/2);
//   * the windows q_pad[q0 + qoff :][:S] and t_pad[t0 + toff :][:S + W],
//     each start taken as lax.dynamic_slice takes it: a negative start
//     wraps by the row width, then clamps into [0, width - size];
//   * the segment of dp_body with tmax = rem_t, unpacked as the
//     reference's _unpack_best (v >= VINF: d = INF, ind = 0);
//   * m = max(floor((r + j + ind) / 2) - d, 0), a = m + d, and ok = r + j
//     > 0 & d < INF & (m / max(a, 1) >= min_seg_identity | a < 32), the
//     quotient and the threshold in float32;
//   * the move form stores the segment in slot nsegs: its moves, r, w, the
//     qoff and toff it started from, and ok;
//   * where ok, qoff, toff, dist, matches, alen advance by r, j, d, m, a;
//     nsegs += 1; active = ok & r >= seg_q - max(1, S/4) & r >= 1 &
//     qoff < qlen & toff < tlen.
//
// A lane that stops never starts again and a stopped lane changes nothing,
// so each lane run to its own end gives the batch loop's result.  The
// slots a lane never reaches are left unwritten: the caller knows where
// each lane stopped and fills them with the record of an inactive lane.
//
// Design: the persistent warps of the per-segment kernel, one lane a warp
// from the counter, now run the lane's segments to its end before taking
// the next lane.  Per segment the warp stages the two windows with byte
// loads (a window starts anywhere in its row, so the 16-byte path of
// dp_lane does not apply), runs dp_body (the code the per-segment kernel
// runs), and every thread applies the rule to the endpoint it holds after
// the body's reduction, so the state lives in registers and needs no
// broadcast.  The quotient is __fdiv_rn (no fast math) and the threshold
// comes from the host already rounded to float32; >> and & floor.
//
// What bounds it: the cells of the segments the data runs, at 12 int32
// operations a cell (18 with moves), beside the move bytes written (S*W/4 a
// lane-segment), and the lane with the longest chain: each of its segments
// is 2r + W dependent steps, and the next one's windows start where this
// one's endpoint lies.  All lanes of a batch start together and most stop
// within a few segments, so a launch ends with few live warps, each on its
// own chain.
struct ExtendArgs {
  const uint8_t* q_pad;    // [N, Lq], query rows with S sentinel bytes
  const uint8_t* t_pad;    // [N, Lt], framed target rows
  const int32_t* q0;       // [N] window offsets of the direction's start
  const int32_t* t0;
  const int32_t* qlen;     // [N] bases available in this direction
  const int32_t* tlen;
  int32_t* out;            // [6, N]: qoff, toff, dist, matches, alen, nsegs
  int32_t* next_lane;      // one int32: the lane counter
  // the move form's slots, [G, N] (moves [G, N, S, W/16])
  int32_t* moves;
  int32_t* r_end;
  int32_t* w_end;
  int32_t* qoff_before;
  int32_t* toff_before;
  uint8_t* ok;
  int N, S, W, Lq, Lt;
  int max_segs;            // lanes below `split`
  int split;
  int max_segs_b;          // lanes from `split` on
  float min_identity;
};

constexpr int kInf = 1 << 20;           // ops.align.INF

// The start lax.dynamic_slice takes for a window of `size` in a row of
// `width` (width >= size).
__device__ __forceinline__ int window_start(int start, const int width,
                                            const int size) {
  if (start < 0) start += width;
  return min(max(start, 0), width - size);
}

// A cluster lane's blocks keep the lane's state each: it follows from the
// lane's inputs and the endpoints rank 0 reduced, the same in every block,
// so the blocks run the same segments and leave together.
template <int C, bool kMoves, int kW, bool kWide = false,
          bool kCluster = false>
__global__ void __launch_bounds__(32 * (kWide ? kMaxSlices : kWarps))
extend_kernel(const ExtendArgs a) {
  extern __shared__ uint4 smem_vec[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = a.S, W = kW ? kW : a.W;
  const int half = W / 2;
  uint8_t *ring, *qs;
  Wide wide;
  int* slot = nullptr;
  if constexpr (kCluster)
    cluster_lane_smem<kMoves>(reinterpret_cast<uint8_t*>(smem_vec), S,
                              &wide, &ring, &qs, &slot);
  else if constexpr (kWide)
    wide_lane_smem<kMoves>(reinterpret_cast<uint8_t*>(smem_vec), S, &wide,
                           &ring, &qs, &slot);
  else
    warp_smem<C, kMoves>(reinterpret_cast<uint8_t*>(smem_vec), warp, S, W,
                         &ring, &qs);
  const int Wp = kWide ? 32 * C * wide.n : 32 * C;  // cells the lane holds
  // this thread among the lane's
  const int t = kCluster ? wide.k * 32 + lane : (kWide ? threadIdx.x : lane);
  const int nt = kWide ? blockDim.x : 32;
  const int slack = max(1, S / 4);
  const size_t lane_words = (size_t)S * (W / 16);
  for (;;) {
    const int b = take_lane<kWide, kCluster>(a.next_lane, slot);
    if (b >= a.N) return;
    const int max_segs = b < a.split ? a.max_segs : a.max_segs_b;
    const int qlen = a.qlen[b], tlen = a.tlen[b];
    const int q0 = a.q0[b], t0 = a.t0[b];
    const uint8_t* qrow = a.q_pad + (size_t)b * a.Lq;
    const uint8_t* trow = a.t_pad + (size_t)b * a.Lt;
    int qoff = 0, toff = 0, dist = 0, matches = 0, alen = 0, nsegs = 0;
    bool active = qlen > 0 && tlen > 0;
    while (active && nsegs < max_segs) {
      const int seg_q = min(max(qlen - qoff, 0), S);
      const int rem_t = min(max(tlen - toff, 0), S + half);
      const uint8_t* qg = qrow + window_start(q0 + qoff, a.Lq, S);
      const uint8_t* tg = trow + window_start(t0 + toff, a.Lt, S + W);
      // the last segment's reads are done
      lane_sync<kWide, kCluster>();
      if constexpr (kCluster) {
        cluster_stage(qs, qg, tg, S, W, wide);
      } else {
        for (int x = t; x < S; x += nt) qs[Wp / 2 + x] = qg[x];
        for (int x = t; x < S + W; x += nt) qs[S + Wp + x] = tg[x];
      }
      lane_sync<kWide, kCluster>();
      const size_t sl = (size_t)nsegs * a.N + b;
      const int3 e = dp_body<C, kMoves, kW, kWide, kCluster>(
          qs, rem_t, seg_q, S, W, lane, ring,
          kMoves ? reinterpret_cast<uint32_t*>(a.moves) + sl * lane_words
                 : nullptr,
          wide);
      const int r = e.x;
      const int j = r - half + e.y;
      const bool vinf = e.z >= (int)kVinf;
      const int d = vinf ? kInf : e.z >> 12;
      const int ind = vinf ? 0 : e.z & (kIndK - 1);
      const int m = max(((r + j + ind) >> 1) - d, 0);
      const int al = m + d;
      const float ident = __fdiv_rn((float)m, (float)max(al, 1));
      const bool ok = r + j > 0 && d < kInf &&
                      (ident >= a.min_identity || al < 32);
      if (kMoves && t == 0) {
        a.r_end[sl] = r;
        a.w_end[sl] = e.y;
        a.qoff_before[sl] = qoff;
        a.toff_before[sl] = toff;
        a.ok[sl] = ok;
      }
      if (ok) {
        qoff += r;
        toff += j;
        dist += d;
        matches += m;
        alen += al;
      }
      ++nsegs;
      active = ok && r >= seg_q - slack && r >= 1 && qoff < qlen &&
               toff < tlen;
    }
    if (t == 0) {
      const size_t n = (size_t)a.N;
      a.out[b] = qoff;
      a.out[n + b] = toff;
      a.out[2 * n + b] = dist;
      a.out[3 * n + b] = matches;
      a.out[4 * n + b] = alen;
      a.out[5 * n + b] = nsegs;
    }
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: fine up to the
// default, after an opt-in up to the block's limit, refused above it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, const size_t smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The grid of persistent warps for B lanes: kResident warps for every
// scheduler of the card, or fewer when the launch has fewer lanes (a block
// is one warp on each of the SM's four schedulers).  Zeroes the lane
// counter on the stream first.
cudaError_t persistent_grid(int B, void* next_lane, cudaStream_t stream,
                            int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess) err = cudaMemsetAsync(next_lane, 0, 4, stream);
  const int blocks = (B + kWarps - 1) / kWarps;
  *grid = blocks < sms * kResident ? blocks : sms * kResident;
  return err;
}

// The grid of a wide lane's persistent blocks (n warps each, `smem` bytes):
// every block the card holds at once, or fewer when the launch has fewer
// lanes; cudaErrorInvalidValue where not one fits an SM.  Zeroes the lane
// counter on the stream first.
template <typename Kernel>
cudaError_t wide_grid(Kernel kernel, int B, int n, size_t smem,
                      void* next_lane, cudaStream_t stream, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * n, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidValue;
  if (err == cudaSuccess) err = cudaMemsetAsync(next_lane, 0, 4, stream);
  *grid = B < sms * per_sm ? B : sms * per_sm;
  return err;
}

bool band_ok(int W) {
  return W % 16 == 0 && W >= kMinW && W <= kClusterMaxW;
}

// warps of a lane at band W: one up to kSliceW, then a warp a slice
int slices_for(int W) { return (W + kSliceW - 1) / kSliceW; }

// Launches `kernel` (a cluster lane's instance) with `args` for B lanes at
// band W: persistent clusters of m blocks of p warps (see "Past 3072"), as
// many as the card holds at once, or fewer when the launch has fewer lanes;
// cudaErrorInvalidValue where the block's shared memory passes the limit
// or not one cluster fits the card.  Zeroes the lane counter on the stream
// first.
template <bool kMoves, typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), const int B,
                           const int S, const int W, void* next_lane,
                           cudaStream_t stream, Args... args) {
  const int n = slices_for(W);
  const int m = cluster_size(n), p = cluster_warps(n);
  const size_t smem = cluster_smem(S, p, kMoves);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = m;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m);
  cfg.blockDim = dim3(32 * p);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(next_lane, 0, 4, stream);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((unsigned)((B < clusters ? B : clusters) * m));
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C, bool kMoves, int kW>
cudaError_t launch(const void* q, const void* tpad, const void* tmax,
                   const void* segq, const void* active, void* r, void* w,
                   void* v, void* moves, void* next_lane, int B, int S, int W,
                   cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * lane_smem(S, W, C, kMoves);
  cudaError_t err = allow_smem(dp_segment_kernel<C, kMoves, kW>, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(B, next_lane, stream, &grid);
  if (err != cudaSuccess) return err;
  dp_segment_kernel<C, kMoves, kW><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(tpad),
      static_cast<const int32_t*>(tmax), static_cast<const int32_t*>(segq),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(r),
      static_cast<int32_t*>(w), static_cast<int32_t*>(v),
      static_cast<int32_t*>(moves), static_cast<int32_t*>(next_lane), B, S,
      W);
  return cudaGetLastError();
}

template <bool kMoves>
cudaError_t launch_wide(const void* q, const void* tpad, const void* tmax,
                        const void* segq, const void* active, void* r,
                        void* w, void* v, void* moves, void* next_lane, int B,
                        int S, int W, cudaStream_t stream) {
  const int n = slices_for(W);
  const size_t smem = wide_smem(S, n, kMoves);
  auto kernel = dp_segment_kernel<16, kMoves, 0, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = wide_grid(kernel, B, n, smem, next_lane, stream, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * n, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(tpad),
      static_cast<const int32_t*>(tmax), static_cast<const int32_t*>(segq),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(r),
      static_cast<int32_t*>(w), static_cast<int32_t*>(v),
      static_cast<int32_t*>(moves), static_cast<int32_t*>(next_lane), B, S,
      W);
  return cudaGetLastError();
}

template <bool kMoves>
cudaError_t launch_extend_wide(const ExtendArgs& a, cudaStream_t stream) {
  const int n = slices_for(a.W);
  const size_t smem = wide_smem(a.S, n, kMoves);
  auto kernel = extend_kernel<16, kMoves, 0, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = wide_grid(kernel, a.N, n, smem, a.next_lane, stream, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * n, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C, bool kMoves, int kW>
cudaError_t launch_extend(const ExtendArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * lane_smem(a.S, a.W, C, kMoves);
  cudaError_t err = allow_smem(extend_kernel<C, kMoves, kW>, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(a.N, a.next_lane, stream, &grid);
  if (err != cudaSuccess) return err;
  extend_kernel<C, kMoves, kW><<<grid, 32 * kWarps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kMoves>
int dispatch(const void* q, const void* tpad, const void* tmax,
             const void* segq, const void* active, void* r, void* w, void* v,
             void* moves, void* next_lane, int B, int S, int W,
             void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || !band_ok(W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W > kMaxW)
    return static_cast<int>(launch_cluster<kMoves>(
        dp_segment_kernel<16, kMoves, 0, true, true>, B, S, W, next_lane, st,
        static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(tpad),
        static_cast<const int32_t*>(tmax), static_cast<const int32_t*>(segq),
        static_cast<const uint8_t*>(active), static_cast<int32_t*>(r),
        static_cast<int32_t*>(w), static_cast<int32_t*>(v),
        static_cast<int32_t*>(moves), static_cast<int32_t*>(next_lane), B, S,
        W));
  if (W > kSliceW)
    return static_cast<int>(launch_wide<kMoves>(q, tpad, tmax, segq, active,
                                                r, w, v, moves, next_lane, B,
                                                S, W, st));
#define MECAT_LAUNCH(C, kW)                                                 \
  return launch<C, kMoves, kW>(q, tpad, tmax, segq, active, r, w, v, moves, \
                               next_lane, B, S, W, st)
  switch (W) {                  // the paths' widths: W fixed in the instance
    case 64: MECAT_LAUNCH(2, 64);
    case 128: MECAT_LAUNCH(4, 128);
  }
  switch (cells_for(W)) {
    case 2: MECAT_LAUNCH(2, 0);
    case 4: MECAT_LAUNCH(4, 0);
    case 6: MECAT_LAUNCH(6, 0);
    case 8: MECAT_LAUNCH(8, 0);
    case 10: MECAT_LAUNCH(10, 0);
    case 12: MECAT_LAUNCH(12, 0);
    case 14: MECAT_LAUNCH(14, 0);
    default: MECAT_LAUNCH(16, 0);
  }
#undef MECAT_LAUNCH
}

template <bool kMoves>
int dispatch_extend(const ExtendArgs& a, void* stream) {
  if (a.N <= 0) return 0;
  if (a.S <= 0 || !band_ok(a.W) || a.Lq < a.S || a.Lt < a.S + a.W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.W > kMaxW)
    return static_cast<int>(launch_cluster<kMoves>(
        extend_kernel<16, kMoves, 0, true, true>, a.N, a.S, a.W, a.next_lane,
        st, a));
  if (a.W > kSliceW)
    return static_cast<int>(launch_extend_wide<kMoves>(a, st));
#define MECAT_LAUNCH(C, kW) \
  return static_cast<int>(launch_extend<C, kMoves, kW>(a, st))
  switch (a.W) {                // the paths' widths: W fixed in the instance
    case 64: MECAT_LAUNCH(2, 64);
    case 128: MECAT_LAUNCH(4, 128);
  }
  switch (cells_for(a.W)) {
    case 2: MECAT_LAUNCH(2, 0);
    case 4: MECAT_LAUNCH(4, 0);
    case 6: MECAT_LAUNCH(6, 0);
    case 8: MECAT_LAUNCH(8, 0);
    case 10: MECAT_LAUNCH(10, 0);
    case 12: MECAT_LAUNCH(12, 0);
    case 14: MECAT_LAUNCH(14, 0);
    default: MECAT_LAUNCH(16, 0);
  }
#undef MECAT_LAUNCH
}

}  // namespace

// q uint8 [B, S], tpad uint8 [B, S + W] (W/2 leading sentinels), tmax and
// segq int32 [B], active uint8/bool [B]; outputs int32 [B] each: best row,
// best band cell, packed value; next_lane one int32 of scratch, which the
// call zeroes and the kernel counts lanes in.  All device pointers,
// row-major, contiguous.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue, without a launch, for a W that is not
// a multiple of 16 in [16, 24576], an S below 1 or an S whose staging does
// not fit the block's shared memory.
extern "C" int mecat_dp_segment_best(const void* q, const void* tpad,
                                     const void* tmax, const void* segq,
                                     const void* active, void* r, void* w,
                                     void* v, void* next_lane, int B, int S,
                                     int W, void* stream) {
  return dispatch<false>(q, tpad, tmax, segq, active, r, w, v, nullptr,
                         next_lane, B, S, W, stream);
}

// The same, and also the packed moves: int32 [B, S, W/16], uninitialised:
// the kernel writes every word, zeros in the rows it does not compute.
extern "C" int mecat_dp_segment_best_moves(const void* q, const void* tpad,
                                           const void* tmax, const void* segq,
                                           const void* active, void* r,
                                           void* w, void* v, void* moves,
                                           void* next_lane, int B, int S,
                                           int W, void* stream) {
  return dispatch<true>(q, tpad, tmax, segq, active, r, w, v, moves,
                        next_lane, B, S, W, stream);
}

// The counts-only segment loop of one direction for N lanes (see
// extend_kernel): q_pad uint8 [N, Lq], t_pad uint8 [N, Lt] (W/2 leading
// sentinels), q0, t0, qlen, tlen int32 [N]; out int32 [6, N] (qoff, toff,
// dist, matches, alen, nsegs), every element written; next_lane one int32
// of scratch.  All device pointers, row-major, contiguous.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without a launch, for a W that is not a multiple
// of 16 in [16, 24576], rows narrower than a window, or an S whose staging
// does not fit the block's shared memory.
extern "C" int mecat_extend_counts(const void* q_pad, const void* t_pad,
                                   const void* q0, const void* t0,
                                   const void* qlen, const void* tlen,
                                   void* out, void* next_lane, int N, int S,
                                   int W, int Lq, int Lt, int max_segs,
                                   float min_identity, void* stream) {
  ExtendArgs a{};
  a.q_pad = static_cast<const uint8_t*>(q_pad);
  a.t_pad = static_cast<const uint8_t*>(t_pad);
  a.q0 = static_cast<const int32_t*>(q0);
  a.t0 = static_cast<const int32_t*>(t0);
  a.qlen = static_cast<const int32_t*>(qlen);
  a.tlen = static_cast<const int32_t*>(tlen);
  a.out = static_cast<int32_t*>(out);
  a.next_lane = static_cast<int32_t*>(next_lane);
  a.N = N;
  a.S = S;
  a.W = W;
  a.Lq = Lq;
  a.Lt = Lt;
  a.max_segs = max_segs;
  a.split = N;
  a.max_segs_b = max_segs;
  a.min_identity = min_identity;
  return dispatch_extend<false>(a, stream);
}

// The move-writing segment loop for N lanes: lanes below `split` run at
// most max_segs segments, the others max_segs_b.  Inputs and `out` as
// mecat_extend_counts; per segment slot k and lane b, for k < the lane's
// nsegs only (the other slots are left as they were): moves int32
// [G, N, S, W/16] (16-byte aligned), r_end, w_end, qoff_before, toff_before
// int32 and ok uint8 [G, N], G >= max(max_segs, max_segs_b).  Returns as
// mecat_extend_counts.
extern "C" int mecat_extend_moves(const void* q_pad, const void* t_pad,
                                  const void* q0, const void* t0,
                                  const void* qlen, const void* tlen,
                                  void* out, void* moves, void* r_end,
                                  void* w_end, void* qoff_before,
                                  void* toff_before, void* ok,
                                  void* next_lane, int N, int S, int W,
                                  int Lq, int Lt, int max_segs, int split,
                                  int max_segs_b, float min_identity,
                                  void* stream) {
  ExtendArgs a{};
  a.q_pad = static_cast<const uint8_t*>(q_pad);
  a.t_pad = static_cast<const uint8_t*>(t_pad);
  a.q0 = static_cast<const int32_t*>(q0);
  a.t0 = static_cast<const int32_t*>(t0);
  a.qlen = static_cast<const int32_t*>(qlen);
  a.tlen = static_cast<const int32_t*>(tlen);
  a.out = static_cast<int32_t*>(out);
  a.next_lane = static_cast<int32_t*>(next_lane);
  a.moves = static_cast<int32_t*>(moves);
  a.r_end = static_cast<int32_t*>(r_end);
  a.w_end = static_cast<int32_t*>(w_end);
  a.qoff_before = static_cast<int32_t*>(qoff_before);
  a.toff_before = static_cast<int32_t*>(toff_before);
  a.ok = static_cast<uint8_t*>(ok);
  a.N = N;
  a.S = S;
  a.W = W;
  a.Lq = Lq;
  a.Lt = Lt;
  a.max_segs = max_segs;
  a.split = split;
  a.max_segs_b = max_segs_b;
  a.min_identity = min_identity;
  return dispatch_extend<true>(a, stream);
}
