// Row-update cost decomposition of the banded DP: five variants of one
// S-row loop, one warp per lane.
//
// Replaces the TPU kernel family tools/roll_micro.py:build_call (body
// make_kernel), a micro-benchmark that times the counts-only row update of
// the DP segment kernel with one cost removed at a time.  A variant is the
// pair (rolls, best); each is a well-defined integer function of
// (q, t, tmax, segq) and this file computes exactly that function:
//
//   full      rolls,    best = log    the row update with its per-row best
//   noroll    no rolls, best = log    neighbour exchange removed
//   nobest    rolls,    best = none   best-cell tracking removed
//   elembest  rolls,    best = elem   best as a packed per-cell key
//   baremin   no rolls, best = none   the diag/vert/min floor
//
// The row update, for row i = 1..S and band cell w (target j = i - W/2 + w,
// valid when 0 <= j <= tmax; there is no sentinel frame, no active flag and
// no early stop, the tool times a fixed amount of work):
//
//   diag = prev[w] + (q[i-1] != t[i-1+w]) * 4096
//   vert = (w < W-1 ? prev[w+1] : VINF) + 4097        (no rolls: prev[w])
//   cand = valid ? min(diag, vert) : VINF
//   cur  = valid ? min(min_{u<=w}(cand[u] - u*4097) + w*4097, VINF) : VINF
//                                                     (no rolls: cand)
//
// On the TPU a "roll" is a sublane rotation; here the same movement is a
// warp shuffle, so a variant without rolls reads the thread's own register
// where the full form shuffles.  The TPU body's closure is a log-step scan
// that pads with VINF and, without rolls, degenerates to min(y, VINF) on
// the lower half of the band; after "+ w*4097, min VINF" both are the plain
// prefix minimum, respectively the identity, which is what runs here.
//
//   best = log   per row: score = (valid & cur < VINF & i <= segq) ?
//                i + j - 4 * (cur / 4096) : -2^26; three warp reductions
//                (max score, first cell holding it, its value); the row
//                replaces the running best when its max is strictly larger.
//                The running best starts at (score 0, row 0, cell W/2,
//                value 0).  Output row: [row, cell, value, score, 0, 0, 0, 0].
//   best = elem  per cell: key = score * 1024 - i in wrapping int32 (a
//                masked score of -2^26 wraps to key = -i; the product is
//                taken as uint32_t, signed overflow being undefined here),
//                kept with its value where strictly larger; one reduction
//                at the end.  Output: [(-kmax) mod 1024 (floored), first
//                cell holding kmax, its value, 0, 0, 0, 0, 0].
//   best = none  Output: the last row's first 8 band cells.
//
// What bounds it on an H100: int32 ALU.  A lane reads S + (S + W) bytes and
// writes 32, against S * W cells of about (operations per cell, counted on
// the statements above with the shuffles and reductions spread over the
// thread's cells):
//
//   baremin 11   nobest 14   noroll 25   elembest 26   full 28
//
// The design is that of dp_segment.cu: the row lives in registers, W/32
// adjacent cells per thread; prev[w+1] comes from the next thread through
// __shfl_down_sync; the closure is a serial scan of the thread's cells plus
// a 5-step __shfl_up_sync scan; the per-row reductions of best = log are
// __reduce_max_sync / __reduce_min_sync; q and t are staged in shared
// memory once per lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmecat_roll_micro.so roll_micro.cu
// Bound with ctypes by mecat_tpu_torch/ops/roll_micro.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIndK = 4096;
constexpr int kK1 = kIndK + 1;
constexpr int kVinf = 1 << 30;
constexpr int kNeg = -(1 << 26);
constexpr int kTwoPenalty = 4;
constexpr int kWarps = 4;               // lanes (warps) per block
constexpr int kIdent = 0x7fffffff;      // identity of the min scan
constexpr unsigned kFull = 0xffffffffu;

constexpr int kBestNone = 0;
constexpr int kBestLog = 1;
constexpr int kBestElem = 2;

// C: band cells per thread, W = 32 * C
template <int C, bool kRolls, int kBest>
__global__ void __launch_bounds__(32 * kWarps)
roll_micro_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  const int32_t* __restrict__ tmax,
                  const int32_t* __restrict__ segq, int32_t* __restrict__ out,
                  int B, int S) {
  constexpr int W = 32 * C;
  constexpr int half = W / 2;
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together; only __syncwarp below

  uint8_t* qs = smem + warp * (2 * S + W);
  uint8_t* ts = qs + S;
  const uint8_t* qg = q + (size_t)b * S;
  const uint8_t* tg = t + (size_t)b * (S + W);
  for (int x = lane; x < S; x += 32) qs[x] = qg[x];
  for (int x = lane; x < S + W; x += 32) ts[x] = tg[x];
  __syncwarp();

  const int tm = tmax[b];
  const int sq = segq[b];
  const int w0 = lane * C;

  int prev[C], key[C], kval[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = w0 + c - half;
    prev[c] = (j >= 0 && j <= tm) ? j * kK1 : kVinf;
    key[c] = kNeg;
    kval[c] = kVinf;
  }
  int bs = 0, br = 0, bw = half, bd = 0;  // best = log, equal in every thread

  for (int i = 1; i <= S; ++i) {
    const int qc = qs[i - 1];
    int nxt = kVinf;
    if (kRolls) {
      nxt = __shfl_down_sync(kFull, prev[0], 1);
      if (lane == 31) nxt = kVinf;
    }
    int cur[C];
    bool valid[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      const int sub = qc != ts[i - 1 + w];
      const int diag = prev[c] + sub * kIndK;
      int vsrc;
      if (kRolls) {
        vsrc = (c + 1 < C) ? prev[c + 1] : nxt;
      } else {
        vsrc = (w < W - 1) ? prev[c] : kVinf;
      }
      const int vert = vsrc + kK1;
      const int j = i - half + w;
      valid[c] = j >= 0 && j <= tm;
      cur[c] = valid[c] ? min(diag, vert) : kVinf;
    }
    if (kRolls) {
      // horizontal closure: prefix min of cand - w * K1 along the band
      int y[C];
#pragma unroll
      for (int c = 0; c < C; ++c) y[c] = cur[c] - (w0 + c) * kK1;
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
#pragma unroll
      for (int c = 0; c < C; ++c) cur[c] = min(y[c], excl) + (w0 + c) * kK1;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cur[c] = valid[c] ? min(cur[c], kVinf) : kVinf;
      prev[c] = cur[c];
    }

    if (kBest != kBestNone) {
      int score[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = i - half + w0 + c;
        const bool ok = valid[c] && cur[c] < kVinf && i <= sq;
        // cur >= 0: the shift is the floor division by 4096
        score[c] = ok ? i + j - kTwoPenalty * (cur[c] >> 12) : kNeg;
      }
      if (kBest == kBestLog) {
        int m = score[0];
#pragma unroll
        for (int c = 1; c < C; ++c) m = max(m, score[c]);
        const int row_max = __reduce_max_sync(kFull, m);
        int a = W;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (score[c] == row_max) a = w0 + c;
        const int row_arg = __reduce_min_sync(kFull, a);
        int d = kVinf;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (w0 + c == row_arg) d = min(d, cur[c]);
        const int row_d = __reduce_min_sync(kFull, d);
        if (row_max > bs) {
          bs = row_max;
          br = i;
          bw = row_arg;
          bd = row_d;
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = (int32_t)((uint32_t)score[c] * 1024u - (uint32_t)i);
          if (k > key[c]) {
            key[c] = k;
            kval[c] = cur[c];
          }
        }
      }
    }
  }

  int32_t* o = out + (size_t)b * 8;
  if (kBest == kBestNone) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (w0 + c < 8) o[w0 + c] = prev[c];
    return;
  }
  int r0, r1, r2, r3 = 0;
  if (kBest == kBestLog) {
    r0 = br;
    r1 = bw;
    r2 = bd;
    r3 = bs;
  } else {
    int m = key[0];
#pragma unroll
    for (int c = 1; c < C; ++c) m = max(m, key[c]);
    const int kmax = __reduce_max_sync(kFull, m);
    int a = W;
#pragma unroll
    for (int c = C - 1; c >= 0; --c)
      if (key[c] == kmax) a = w0 + c;
    const int warg = __reduce_min_sync(kFull, a);
    int d = kVinf;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (w0 + c == warg) d = min(d, kval[c]);
    const int vbest = __reduce_min_sync(kFull, d);
    int rmod = (-kmax) % 1024;  // C truncates: floor it
    if (rmod < 0) rmod += 1024;
    r0 = rmod;
    r1 = warg;
    r2 = vbest;
  }
  if (lane == 0) {
    o[0] = r0;
    o[1] = r1;
    o[2] = r2;
    o[3] = r3;
    o[4] = o[5] = o[6] = o[7] = 0;
  }
}

constexpr size_t kSmemLimit = 48 * 1024;  // without an opt-in attribute

template <int C, bool kRolls, int kBest>
cudaError_t launch(const void* q, const void* t, const void* tmax,
                   const void* segq, void* out, int B, int S,
                   cudaStream_t stream) {
  const int W = 32 * C;
  const size_t smem = (size_t)kWarps * (2 * S + W);
  if (S <= 0 || smem > kSmemLimit) return cudaErrorInvalidValue;
  const int grid = (B + kWarps - 1) / kWarps;
  roll_micro_kernel<C, kRolls, kBest><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int32_t*>(tmax), static_cast<const int32_t*>(segq),
      static_cast<int32_t*>(out), B, S);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch(const void* q, const void* t, const void* tmax,
                     const void* segq, void* out, int B, int S, int rolls,
                     int best, cudaStream_t st) {
  if (rolls && best == kBestLog)
    return launch<C, true, kBestLog>(q, t, tmax, segq, out, B, S, st);
  if (!rolls && best == kBestLog)
    return launch<C, false, kBestLog>(q, t, tmax, segq, out, B, S, st);
  if (rolls && best == kBestNone)
    return launch<C, true, kBestNone>(q, t, tmax, segq, out, B, S, st);
  if (rolls && best == kBestElem)
    return launch<C, true, kBestElem>(q, t, tmax, segq, out, B, S, st);
  if (!rolls && best == kBestNone)
    return launch<C, false, kBestNone>(q, t, tmax, segq, out, B, S, st);
  return cudaErrorInvalidValue;  // (no rolls, elem) is not one of the five
}

}  // namespace

// q uint8 [B, S], t uint8 [B, S + W], tmax and segq int32 [B]; out int32
// [B, 8].  rolls 0/1; best 0 none, 1 log, 2 elem.  All device pointers,
// row-major, contiguous.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue, without a launch, for a W other than
// 32, 64 or 128, a (rolls, best) pair that is not one of the five variants,
// or an S whose q/t staging does not fit the block's shared memory.
extern "C" int mecat_roll_micro(const void* q, const void* t,
                                const void* tmax, const void* segq, void* out,
                                int B, int S, int W, int rolls, int best,
                                void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 32:
      return dispatch<1>(q, t, tmax, segq, out, B, S, rolls, best, st);
    case 64:
      return dispatch<2>(q, t, tmax, segq, out, B, S, rolls, best, st);
    case 128:
      return dispatch<4>(q, t, tmax, segq, out, B, S, rolls, best, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
