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
//   * a thread holds C = W/32 adjacent cells in registers.  Only one value
//     crosses a thread border a step: the horizontal input of the thread's
//     first cell (__shfl_up_sync, even tau) or the vertical input of its
//     last (__shfl_down_sync, odd tau).  A step is one shuffle, an add, a
//     three-way min and a select; a lane of r rows takes 2*r + W steps;
//   * the loop counts k = tau / 2.  In iteration k the thread's cell pair p
//     (cells 2p, 2p+1) stands on row k - w0/2 - p, so the query and target
//     bytes it needs move by one a k: they are kept in registers and one
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
//   * moves: at C = 4 a thread's four cells are byte `lane` of the row's
//     W/4 bytes, its cells 0-1 made one iteration before its cells 2-3: it
//     keeps the low nibble for one iteration and puts the whole byte into a
//     128-row ring in shared memory.  At C = 2 a byte spans two threads
//     whose nibbles of one row are made one iteration apart: the even
//     thread keeps its nibble and fetches the odd thread's with one
//     __shfl_down_sync, which no DP value waits on.  Every 32 iterations
//     the warp writes the 32 rows that have become whole with 16-byte
//     stores;
//   * lanes are handed out at run time: the grid is two warps for every
//     scheduler of the card, and a warp takes the next lane from a counter
//     until none is left, so the live lanes of a launch spread over the
//     card wherever they lie among the inactive ones (see kResident).
//
// The result is exact.  The counts-only body also runs inside
// extend_counts_kernel (entry mecat_extend_counts, below), which carries a
// lane's whole segment loop, so the counts paths launch once a batch.
// Left for later: several lanes per warp at W=64, and the move-writing
// segment loop of the correction and mapping paths.
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
constexpr int kWarps = 4;               // warps per block
// Blocks per SM, so warps per scheduler.  On an H100 with 1,024 live lanes
// scattered over 4,096, 2 / 3 / 4 / 6 took 0.075 / 0.104 / 0.134 / 0.181 ms
// (counts, S=512, W=128), and one warp per lane with every block resident
// 0.157: more warps only let live lanes pile up on one scheduler.  With all
// 4,096 live the order turns (0.270 / 0.248 / 0.245 / 0.249, every block
// resident 0.204), but no caller launches that.
constexpr int kResident = 2;
constexpr int kRing = 128;              // move rows staged per lane
constexpr int kFlush = 32;              // move rows written out at a time
constexpr unsigned kFull = 0xffffffffu;

// compile-time switch handed to the loop body
template <bool kValue>
struct Flag {
  static constexpr bool value = kValue;
};

__device__ __forceinline__ bool better(int s, int f, int bs, int bf) {
  return s > bs || (s == bs && f < bf);
}

// Bytes of shared memory one lane takes: the query with W/2 bytes of
// padding on either side, the framed target window, and with moves the ring.
__host__ __device__ constexpr size_t lane_smem(int S, int W, bool moves) {
  return 2 * (size_t)(S + W) + (moves ? (size_t)kRing * (W / 4) : 0);
}

// The segment of one lane, by one warp, from its staged bytes: `qs` is
// this warp's share of the block's shared memory (see lane_smem), holding
// the query at qs[W/2 ..] and the framed target window at qs[S + W ..];
// tm and sq are the lane's tmax and seg_q.  C: band cells per thread, W =
// 32 * C; kMoves: also write the lane's move rows, [S, W/16] as 16-byte
// vectors at mv_out, through `ring`.  Returns the endpoint (r, w, packed
// v) on every thread of the warp.
template <int C, bool kMoves>
__device__ __forceinline__ int3 dp_body(const uint8_t* qs, const int tm,
                                        const int sq, const int S,
                                        const int lane, uint8_t* ring,
                                        uint4* __restrict__ mv_out) {
  static_assert(C == 2 || C == 4, "a move byte is one or two threads");
  constexpr int W = 32 * C;
  constexpr int half = W / 2;
  constexpr int P = C / 2;              // cell pairs per thread
  constexpr int kRowBytes = W / 4;      // one row of moves
  constexpr int kRowVecs = kRowBytes / 16;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const uint8_t* qsp = qs + half;       // qsp[x] = q[x], x in [-W/2, S + W/2)
  const uint8_t* ts = qs + S + W;       // ts[x] = tpad[x]
  const int w0 = lane * C;
  const int hw0 = w0 / 2;

  // DP values are unsigned: every legitimate value is below 2^30, and a
  // border input that must not count is pushed above VINF by its addend
  // (up to 2^31 + 4097), which an unsigned min still orders
  uint32_t val[C];
  int best_s[C], best_r[C];
  uint32_t best_v[C];
  // row 0: val[0][j] = j leading deletions, VINF outside [0, tmax]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = w0 + c - half;
    const bool valid = j >= 0 && j <= tm;
    val[c] = valid ? (uint32_t)(j * kK1) : kVinf;
    const bool ok = valid && sq >= 0;
    best_s[c] = ok ? j - kTwoPenalty * (int)(val[c] >> 12) : kNeg;
    best_r[c] = 0;
    best_v[c] = val[c];
  }

  // the last row that can hold the endpoint
  int last = min(min(sq, S), tm + half);
  if (tm < 0 || last < 0) last = 0;

  // one indel step on the value that crosses the thread border; the first
  // band cell has no horizontal input and the last no vertical one
  const uint32_t h_add = kK1 + (lane == 0 ? kVinf : 0u);
  const uint32_t v_add = kK1 + (lane == 31 ? kVinf : 0u);

  // the bytes of iteration k: qc[p] = q[k - hw0 - 1 - p], the query char of
  // pair p's row; tc[m] = tpad[k + hw0 - 1 + m], the target char of cell m
  // on its pair's row.  Set up as of k = 0 (slot 0 of tc is shifted out);
  // the two new bytes of an iteration are read one iteration ahead.
  int qc[P], tc[P + 1];
#pragma unroll
  for (int p = 0; p < P; ++p) qc[p] = qsp[-hw0 - 1 - p];
  tc[0] = 0;
#pragma unroll
  for (int m = 1; m <= P; ++m) tc[m] = ts[hw0 - 1 + m];
  int q_next = qsp[-hw0], t_next = ts[hw0 + P];

  uint32_t kept = 0;                    // the nibble made one iteration ago
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
    q_next = qsp[k - hw0];
    t_next = ts[k + hw0 + P];

    uint32_t code[C];
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      // the one value that crosses the thread border this step
      const uint32_t edge_in = par == 0
                                   ? __shfl_up_sync(kFull, val[C - 1], 1)
                                   : __shfl_down_sync(kFull, val[0], 1);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int c = 2 * p + par;
        const int i = k - hw0 - p;
        const int w = w0 + c;
        const uint32_t sub = qc[p] != tc[p + par];
        const uint32_t diag = val[c] + sub * kIndK;
        const uint32_t vert =
            (c + 1 < C) ? val[c + 1] + kK1 : edge_in + v_add;
        const uint32_t hor = (c > 0) ? val[c - 1] + kK1 : edge_in + h_add;
        const int j = i - half + w;
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
    }

    if (kMoves) {
      // the byte that became whole in this iteration, and its row (1-based)
      uint32_t byte;
      const int row = k - hw0 - 1;
      bool mine = true;
      if constexpr (C == 4) {
        byte = kept | (code[2] << 4) | (code[3] << 6);
        kept = code[0] | (code[1] << 2);
      } else {
        const uint32_t nib = code[0] | (code[1] << 2);
        byte = kept | (__shfl_down_sync(kFull, nib, 1) << 4);
        kept = nib;
        mine = (lane & 1) == 0;
      }
      if (kEdge) mine = mine && (unsigned)(row - 1) < (unsigned)last;
      if (mine)
        ring[((row - 1) & (kRing - 1)) * kRowBytes + (w0 >> 2)] =
            (uint8_t)byte;
      // rows 1..k - W/2 + 1 are whole now
      if (k - half + 1 - flushed >= kFlush) {
        __syncwarp();
        for (int u = lane; u < kFlush * kRowVecs; u += 32) {
          const int r0 = flushed + u / kRowVecs;
          mv_out[(size_t)flushed * kRowVecs + u] =
              *reinterpret_cast<const uint4*>(
                  ring + (r0 & (kRing - 1)) * kRowBytes +
                  (u % kRowVecs) * 16);
        }
        flushed += kFlush;
        __syncwarp();
      }
    }
  };

  // Iterations 1..last + W/2 - 1.  In [W/2, last] every cell is on a row
  // of the lane; in [W - 1, tmax - W/2 + 1] the rows k - W/2 + 1..k of the
  // iteration also lie inside the target along the whole band.
  const int k_end = last > 0 ? last + half - 1 : 0;
  int k = 1;
  for (; k <= min(half - 1, k_end); ++k)
    iteration(k, Flag<true>{}, Flag<true>{});
  for (; k <= min(W - 2, last); ++k)
    iteration(k, Flag<false>{}, Flag<true>{});
#pragma unroll 2
  for (; k <= min(tm - half + 1, last); ++k)
    iteration(k, Flag<false>{}, Flag<false>{});
  for (; k <= last; ++k) iteration(k, Flag<false>{}, Flag<true>{});
  for (; k <= k_end; ++k) iteration(k, Flag<true>{}, Flag<true>{});

  if (kMoves) {
    // the rows still in the ring, then zeros for the rows never computed
    __syncwarp();
    for (int u = flushed * kRowVecs + lane; u < last * kRowVecs; u += 32) {
      const int r0 = u / kRowVecs;
      mv_out[u] = *reinterpret_cast<const uint4*>(
          ring + (r0 & (kRing - 1)) * kRowBytes + (u % kRowVecs) * 16);
    }
    for (int u = last * kRowVecs + lane; u < S * kRowVecs; u += 32)
      mv_out[u] = zero4;
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
  return make_int3(f / W, f % W, v);  // f >= 0: truncation is floor
}

// One launch lane of the per-segment kernels, by one warp: stage its q and
// framed target rows, run the segment, write the endpoint (or the skip
// record of an inactive lane, with zero moves).  `ring` and `qs` are this
// warp's shares of the block's shared memory (see the kernel).
template <int C, bool kMoves>
__device__ __forceinline__ void dp_lane(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ tpad,
    const int32_t* __restrict__ tmax, const int32_t* __restrict__ segq,
    const uint8_t* __restrict__ active, int32_t* __restrict__ r_out,
    int32_t* __restrict__ w_out, int32_t* __restrict__ v_out,
    int32_t* __restrict__ moves_out, const int S, const int b,
    const int lane, uint8_t* ring, uint8_t* qs) {
  constexpr int W = 32 * C;
  constexpr int half = W / 2;
  constexpr int kRowVecs = W / 64;      // 16-byte vectors in a move row

  // this lane's move rows, [S, W/16], as 16-byte vectors
  uint4* mv_out =
      kMoves ? reinterpret_cast<uint4*>(moves_out + (size_t)b * S * (W / 16))
             : nullptr;

  if (!active[b]) {
    if (lane == 0) {
      r_out[b] = 0;
      w_out[b] = half;
      v_out[b] = (int32_t)kVinf;
    }
    if (kMoves)
      for (int u = lane; u < S * kRowVecs; u += 32)
        mv_out[u] = make_uint4(0, 0, 0, 0);
    return;
  }

  uint8_t* qsp = qs + half;
  uint8_t* ts = qs + S + W;
  const uint8_t* qg = q + (size_t)b * S;
  const uint8_t* tg = tpad + (size_t)b * (S + W);
  if ((S & 15) == 0 && ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(tpad)) & 15) == 0) {
    // rows and staging are 16-byte aligned
    const uint4* qg4 = reinterpret_cast<const uint4*>(qg);
    const uint4* tg4 = reinterpret_cast<const uint4*>(tg);
    uint4* qs4 = reinterpret_cast<uint4*>(qsp);
    uint4* ts4 = reinterpret_cast<uint4*>(ts);
    for (int x = lane; x < S / 16; x += 32) qs4[x] = qg4[x];
    for (int x = lane; x < (S + W) / 16; x += 32) ts4[x] = tg4[x];
  } else {
    for (int x = lane; x < S; x += 32) qsp[x] = qg[x];
    for (int x = lane; x < S + W; x += 32) ts[x] = tg[x];
  }
  __syncwarp();

  const int3 best = dp_body<C, kMoves>(qs, tmax[b], segq[b], S, lane, ring,
                                       mv_out);
  if (lane == 0) {
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
// a time wherever they lie in the batch.
template <int C, bool kMoves>
__global__ void __launch_bounds__(32 * kWarps)
dp_segment_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ tpad,
                  const int32_t* __restrict__ tmax,
                  const int32_t* __restrict__ segq,
                  const uint8_t* __restrict__ active,
                  int32_t* __restrict__ r_out, int32_t* __restrict__ w_out,
                  int32_t* __restrict__ v_out,
                  int32_t* __restrict__ moves_out,
                  int32_t* __restrict__ next_lane, int B, int S) {
  constexpr int W = 32 * C;
  extern __shared__ uint4 smem_vec[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_vec);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // rings first: they stay 16-byte aligned whatever S is
  uint8_t* ring = smem + (size_t)warp * kRing * (W / 4);
  uint8_t* qs = smem + (kMoves ? (size_t)kWarps * kRing * (W / 4) : 0) +
                (size_t)warp * 2 * (S + W);
  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(next_lane, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= B) return;
    dp_lane<C, kMoves>(q, tpad, tmax, segq, active, r_out, w_out, v_out,
                       moves_out, S, b, lane, ring, qs);
    __syncwarp();  // the next lane restages this warp's shared memory
  }
}

// The counts-only segment loop of one extension direction: every lane run
// to its end in one launch.
//
// Replaces the reference's device loop mecat_tpu/ops/align.py:531-541, the
// jax.lax.while_loop of _extend_direction_impl(collect_ops=False) with body
// seg_step at :468-514, which the port's plain version runs from the host
// with one sync and some 40-75 small kernels a segment.  Per lane, from
// qoff = toff = dist = matches = alen = nsegs = 0 and active = qlen > 0 &
// tlen > 0, while active and fewer than max_segs segments have run:
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
//   * where ok, qoff, toff, dist, matches, alen advance by r, j, d, m, a;
//     nsegs += 1; active = ok & r >= seg_q - max(1, S/4) & r >= 1 &
//     qoff < qlen & toff < tlen.
//
// A lane that stops never starts again and a stopped lane changes nothing,
// so each lane run to its own end gives the batch loop's result.
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
// operations a cell, and the lane with the longest chain: each of its
// segments is 2r + W dependent steps, and the next one's windows start
// where this one's endpoint lies.  All lanes of a batch start together
// and most stop within a few segments, so a launch ends with few live
// warps, each on its own chain.
struct ExtendArgs {
  const uint8_t* q_pad;    // [N, Lq], query rows with S sentinel bytes
  const uint8_t* t_pad;    // [N, Lt], framed target rows
  const int32_t* q0;       // [N] window offsets of the direction's start
  const int32_t* t0;
  const int32_t* qlen;     // [N] bases available in this direction
  const int32_t* tlen;
  int32_t* out;            // [6, N]: qoff, toff, dist, matches, alen, nsegs
  int32_t* next_lane;      // one int32: the lane counter
  int N, S, Lq, Lt, max_segs;
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

template <int C>
__global__ void __launch_bounds__(32 * kWarps)
extend_counts_kernel(const ExtendArgs a) {
  constexpr int W = 32 * C;
  constexpr int half = W / 2;
  extern __shared__ uint4 smem_vec[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = a.S;
  uint8_t* qs = reinterpret_cast<uint8_t*>(smem_vec) +
                (size_t)warp * lane_smem(S, W, false);
  const int slack = max(1, S / 4);
  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(a.next_lane, 1);
    b = __shfl_sync(kFull, b, 0);
    if (b >= a.N) return;
    const int qlen = a.qlen[b], tlen = a.tlen[b];
    const int q0 = a.q0[b], t0 = a.t0[b];
    const uint8_t* qrow = a.q_pad + (size_t)b * a.Lq;
    const uint8_t* trow = a.t_pad + (size_t)b * a.Lt;
    int qoff = 0, toff = 0, dist = 0, matches = 0, alen = 0, nsegs = 0;
    bool active = qlen > 0 && tlen > 0;
    while (active && nsegs < a.max_segs) {
      const int seg_q = min(max(qlen - qoff, 0), S);
      const int rem_t = min(max(tlen - toff, 0), S + half);
      const uint8_t* qg = qrow + window_start(q0 + qoff, a.Lq, S);
      const uint8_t* tg = trow + window_start(t0 + toff, a.Lt, S + W);
      __syncwarp();                     // the last segment's reads are done
      for (int x = lane; x < S; x += 32) qs[half + x] = qg[x];
      for (int x = lane; x < S + W; x += 32) qs[S + W + x] = tg[x];
      __syncwarp();
      const int3 e =
          dp_body<C, false>(qs, rem_t, seg_q, S, lane, nullptr, nullptr);
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
    if (lane == 0) {
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

constexpr size_t kSmemLimit = 48 * 1024;  // without an opt-in attribute

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

template <int C, bool kMoves>
cudaError_t launch(const void* q, const void* tpad, const void* tmax,
                   const void* segq, const void* active, void* r, void* w,
                   void* v, void* moves, void* next_lane, int B, int S,
                   cudaStream_t stream) {
  const int W = 32 * C;
  if (S <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * lane_smem(S, W, kMoves);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(B, next_lane, stream, &grid);
  if (err != cudaSuccess) return err;
  dp_segment_kernel<C, kMoves><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(tpad),
      static_cast<const int32_t*>(tmax), static_cast<const int32_t*>(segq),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(r),
      static_cast<int32_t*>(w), static_cast<int32_t*>(v),
      static_cast<int32_t*>(moves), static_cast<int32_t*>(next_lane), B, S);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_extend(const ExtendArgs& a, cudaStream_t stream) {
  const int W = 32 * C;
  if (a.S <= 0 || a.Lq < a.S || a.Lt < a.S + W) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * lane_smem(a.S, W, false);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(a.N, a.next_lane, stream, &grid);
  if (err != cudaSuccess) return err;
  extend_counts_kernel<C><<<grid, 32 * kWarps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kMoves>
int dispatch(const void* q, const void* tpad, const void* tmax,
             const void* segq, const void* active, void* r, void* w, void* v,
             void* moves, void* next_lane, int B, int S, int W,
             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64:
      return launch<2, kMoves>(q, tpad, tmax, segq, active, r, w, v, moves,
                               next_lane, B, S, st);
    case 128:
      return launch<4, kMoves>(q, tpad, tmax, segq, active, r, w, v, moves,
                               next_lane, B, S, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q uint8 [B, S], tpad uint8 [B, S + W] (W/2 leading sentinels), tmax and
// segq int32 [B], active uint8/bool [B]; outputs int32 [B] each: best row,
// best band cell, packed value; next_lane one int32 of scratch, which the
// call zeroes and the kernel counts lanes in.  All device pointers,
// row-major, contiguous.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue, without a launch, for a W other than
// 64 or 128 or an S whose q/t staging does not fit the block's shared
// memory.
extern "C" int mecat_dp_segment_best(const void* q, const void* tpad,
                                     const void* tmax, const void* segq,
                                     const void* active, void* r, void* w,
                                     void* v, void* next_lane, int B, int S,
                                     int W, void* stream) {
  return dispatch<false>(q, tpad, tmax, segq, active, r, w, v, nullptr,
                         next_lane, B, S, W, stream);
}

// The same, and also the packed moves: int32 [B, S, W/16], 16-byte aligned
// and uninitialised: the kernel writes every word, zeros in the rows it does
// not compute.
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
// extend_counts_kernel): q_pad uint8 [N, Lq], t_pad uint8 [N, Lt] (W/2
// leading sentinels), q0, t0, qlen, tlen int32 [N]; out int32 [6, N]
// (qoff, toff, dist, matches, alen, nsegs), every element written;
// next_lane one int32 of scratch.  All device pointers, row-major,
// contiguous.  Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue, without a launch, for a W other than 64 or
// 128, rows narrower than a window, or an S whose staging does not fit the
// block's shared memory.
extern "C" int mecat_extend_counts(const void* q_pad, const void* t_pad,
                                   const void* q0, const void* t0,
                                   const void* qlen, const void* tlen,
                                   void* out, void* next_lane, int N, int S,
                                   int W, int Lq, int Lt, int max_segs,
                                   float min_identity, void* stream) {
  if (N <= 0) return 0;
  const ExtendArgs a{static_cast<const uint8_t*>(q_pad),
                     static_cast<const uint8_t*>(t_pad),
                     static_cast<const int32_t*>(q0),
                     static_cast<const int32_t*>(t0),
                     static_cast<const int32_t*>(qlen),
                     static_cast<const int32_t*>(tlen),
                     static_cast<int32_t*>(out),
                     static_cast<int32_t*>(next_lane),
                     N, S, Lq, Lt, max_segs, min_identity};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64:
      return static_cast<int>(launch_extend<2>(a, st));
    case 128:
      return static_cast<int>(launch_extend<4>(a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
