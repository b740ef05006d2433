// Banded edit-distance DP segment + local-best endpoint, one warp per lane.
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
//     Rows the loop never reaches (past seg_q, or after an all-VINF row)
//     are not written: the caller zero-fills the buffer, and no traceback
//     reads a row above its r_best <= seg_q.  An inactive lane writes none.
//
// What bounds it on an H100: int32 ALU, about 15 operations per cell, with
// about 1.2 KB read per lane-segment (S query bytes + S+W target bytes at
// S=512, W=128) and 12 bytes written.  The move-writing form adds about 6
// operations per cell and S*W/4 bytes written per lane (16 KB at S=512,
// W=128), still below the ALU time at the card's memory rate.  There is no
// tensor-core form of a min-plus recurrence, so the design spends nothing
// on memory movement and keeps the whole wavefront in registers:
//
//   * one warp per lane, W/32 adjacent band cells per thread, the previous
//     row in registers;
//   * the vertical neighbour prev[w+1] comes from the next thread's first
//     cell through __shfl_down_sync;
//   * the prefix-min closure is a serial scan over the thread's own cells,
//     then a 5-step __shfl_up_sync scan of the thread minima;
//   * the best cell is tracked per band cell as (score, row, value), with a
//     strict ">" so the earliest row wins; one warp reduction on
//     (score desc, r * W + w asc) after the row loop.  No packed
//     (score, row) key, so nothing aliases at any S;
//   * the query and the framed target window are staged in shared memory
//     once per lane;
//   * rows past seg_q cannot change the endpoint (row i reads only row i-1),
//     and once a whole row is VINF every later row is too, so the row loop
//     stops at either point;
//   * a thread holds C = W/32 adjacent cells, so one 16-code move word spans
//     16/C threads: each builds its partial word (as uint32_t: slot 15 sets
//     the sign bit), the group ORs them with __shfl_xor_sync (2 steps at
//     W=128, 3 at W=64) and its first thread stores the word.  A row is 16
//     or 32 bytes per warp, written as it is made; staging rows in shared
//     memory for wider stores is speed work.
//
// The result is exact; speed work (several lanes per warp at W=64, the
// segment loop inside the kernel) is for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmecat_dp.so dp_segment.cu
// Bound with ctypes by mecat_tpu_torch/ops/dp_kernel.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIndK = 4096;             // ops.align.IND_K
constexpr int kK1 = kIndK + 1;          // one indel step, packed units
constexpr int kVinf = 1 << 30;          // ops.align.VINF
constexpr int kNeg = -(1 << 26);        // pick_end_local's masked score
constexpr int kTwoPenalty = 4;          // 2 * constants.ALIGN_TRIM_PENALTY
constexpr int kWarps = 4;               // lanes (warps) per block
constexpr int kIdent = 0x7fffffff;      // identity of the min scan
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(int s, int f, int bs, int bf) {
  return s > bs || (s == bs && f < bf);
}

// C: band cells per thread, W = 32 * C; kMoves: also write the move words
template <int C, bool kMoves>
__global__ void __launch_bounds__(32 * kWarps)
dp_segment_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ tpad,
                  const int32_t* __restrict__ tmax,
                  const int32_t* __restrict__ segq,
                  const uint8_t* __restrict__ active,
                  int32_t* __restrict__ r_out, int32_t* __restrict__ w_out,
                  int32_t* __restrict__ v_out,
                  int32_t* __restrict__ moves_out, int B, int S) {
  constexpr int W = 32 * C;
  constexpr int half = W / 2;
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together; only __syncwarp below
  if (!active[b]) {
    if (lane == 0) {
      r_out[b] = 0;
      w_out[b] = half;
      v_out[b] = kVinf;
    }
    return;
  }

  uint8_t* qs = smem + warp * (2 * S + W);
  uint8_t* ts = qs + S;
  const uint8_t* qg = q + (size_t)b * S;
  const uint8_t* tg = tpad + (size_t)b * (S + W);
  for (int x = lane; x < S; x += 32) qs[x] = qg[x];
  for (int x = lane; x < S + W; x += 32) ts[x] = tg[x];
  __syncwarp();

  const int tm = tmax[b];
  const int sq = segq[b];
  const int w0 = lane * C;

  // this lane's move rows, [S, W/16]; advanced one row per DP row
  int32_t* mrow = kMoves ? moves_out + (size_t)b * S * (W / 16) : nullptr;

  int prev[C], best_s[C], best_r[C], best_v[C];
  // row 0: val[0][j] = j leading deletions, VINF outside [0, tmax]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = w0 + c - half;
    const bool valid = j >= 0 && j <= tm;
    prev[c] = valid ? j * kK1 : kVinf;
    const bool ok = valid && sq >= 0;
    best_s[c] = ok ? j - kTwoPenalty * (prev[c] >> 12) : kNeg;
    best_r[c] = 0;
    best_v[c] = prev[c];
  }

  const int last_row = sq < S ? sq : S;
  for (int i = 1; i <= last_row; ++i) {
    const int qc = qs[i - 1];
    int nxt = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 31) nxt = kVinf;
    int y[C], dg[C], vt[C], sub_of[C];
    bool valid[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      const int vsrc = (c + 1 < C) ? prev[c + 1] : nxt;
      const int sub = qc != ts[i - 1 + w];
      const int diag = prev[c] + sub * kIndK;
      const int vert = vsrc + kK1;
      const int j = i - half + w;
      valid[c] = j >= 0 && j <= tm;
      const int cand = valid[c] ? min(diag, vert) : kVinf;
      y[c] = cand - w * kK1;
      dg[c] = diag;
      vt[c] = vert;
      sub_of[c] = sub;
    }
    // horizontal closure: prefix min of y along the band
#pragma unroll
    for (int c = 1; c < C; ++c) y[c] = min(y[c], y[c - 1]);
    int tot = y[C - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, tot, off);
      if (lane >= off) tot = min(tot, o);
    }
    int excl = __shfl_up_sync(kFull, tot, 1);
    if (lane == 0) excl = kIdent;
    bool any_live = false;
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      int cur = min(y[c], excl) + w * kK1;
      cur = valid[c] ? min(cur, kVinf) : kVinf;
      prev[c] = cur;
      if (kMoves) {
        const uint32_t mv = cur == dg[c] ? (uint32_t)sub_of[c]
                                         : (cur == vt[c] ? 2u : 3u);
        word |= mv << (2 * (w & 15));
      }
      if (cur < kVinf) {
        any_live = true;
        const int score = i + (i - half + w) - kTwoPenalty * (cur >> 12);
        if (score > best_s[c]) {
          best_s[c] = score;
          best_r[c] = i;
          best_v[c] = cur;
        }
      }
    }
    if (kMoves) {
      // one word = 16 cells = 16 / C neighbouring threads
#pragma unroll
      for (int off = 1; off < 16 / C; off <<= 1)
        word |= __shfl_xor_sync(kFull, word, off);
      if ((lane & (16 / C - 1)) == 0) mrow[w0 >> 4] = (int32_t)word;
      mrow += W / 16;
    }
    if (!__any_sync(kFull, any_live)) break;  // every later row is VINF too
  }

  // per-thread best, then a warp reduction on (score desc, flat index asc)
  int s = best_s[0], f = best_r[0] * W + w0, v = best_v[0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const int fc = best_r[c] * W + w0 + c;
    if (better(best_s[c], fc, s, f)) {
      s = best_s[c];
      f = fc;
      v = best_v[c];
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
  if (lane == 0) {
    r_out[b] = f / W;  // f >= 0: truncation is floor
    w_out[b] = f % W;
    v_out[b] = v;
  }
}

constexpr size_t kSmemLimit = 48 * 1024;  // without an opt-in attribute

template <int C, bool kMoves>
cudaError_t launch(const void* q, const void* tpad, const void* tmax,
                   const void* segq, const void* active, void* r, void* w,
                   void* v, void* moves, int B, int S, cudaStream_t stream) {
  const int W = 32 * C;
  const size_t smem = (size_t)kWarps * (2 * S + W);
  if (S <= 0 || smem > kSmemLimit) return cudaErrorInvalidValue;
  const int grid = (B + kWarps - 1) / kWarps;
  dp_segment_kernel<C, kMoves><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(tpad),
      static_cast<const int32_t*>(tmax), static_cast<const int32_t*>(segq),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(r),
      static_cast<int32_t*>(w), static_cast<int32_t*>(v),
      static_cast<int32_t*>(moves), B, S);
  return cudaGetLastError();
}

template <bool kMoves>
int dispatch(const void* q, const void* tpad, const void* tmax,
             const void* segq, const void* active, void* r, void* w, void* v,
             void* moves, int B, int S, int W, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64:
      return launch<2, kMoves>(q, tpad, tmax, segq, active, r, w, v, moves,
                               B, S, st);
    case 128:
      return launch<4, kMoves>(q, tpad, tmax, segq, active, r, w, v, moves,
                               B, S, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q uint8 [B, S], tpad uint8 [B, S + W] (W/2 leading sentinels), tmax and
// segq int32 [B], active uint8/bool [B]; outputs int32 [B] each: best row,
// best band cell, packed value.  All device pointers, row-major, contiguous.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without a launch, for a W other than 64 or 128 or
// an S whose q/t staging does not fit the block's shared memory.
extern "C" int mecat_dp_segment_best(const void* q, const void* tpad,
                                     const void* tmax, const void* segq,
                                     const void* active, void* r, void* w,
                                     void* v, int B, int S, int W,
                                     void* stream) {
  return dispatch<false>(q, tpad, tmax, segq, active, r, w, v, nullptr, B, S,
                         W, stream);
}

// The same, and also the packed moves: int32 [B, S, W/16], which the caller
// has zero-filled (rows the kernel does not reach keep the zeros).
extern "C" int mecat_dp_segment_best_moves(const void* q, const void* tpad,
                                           const void* tmax, const void* segq,
                                           const void* active, void* r,
                                           void* w, void* v, void* moves,
                                           int B, int S, int W,
                                           void* stream) {
  return dispatch<true>(q, tpad, tmax, segq, active, r, w, v, moves, B, S, W,
                        stream);
}
