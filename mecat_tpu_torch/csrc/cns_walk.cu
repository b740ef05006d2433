// The three device scans of correction and mapping, one launch each.
//
// The JAX package runs each of them as a lax.scan that XLA compiles into one
// device loop; the port's plain versions are Python loops of small torch ops
// (one launch per op per step).  Here each is one kernel:
//
//   * walk_rows (entry mecat_walk_rows) replaces the row walk
//     mecat_tpu/ops/align.py:traceback_rows (scan at :354), plain version
//     ops/align.traceback_rows_plain;
//   * walk_deposit (entry mecat_walk_deposit) replaces the sliding-band
//     deposit mecat_tpu/ops/consensus_banded.py:_deposit_scan (scan at :128),
//     plain version ops/consensus_banded.deposit_scan_plain;
//   * walk_cols (entry mecat_walk_cols) replaces the column walk
//     mecat_tpu/ops/align.py:traceback_ops (scan at :283), plain version
//     ops/align.traceback_ops_plain.
//
// Moves are 2-bit codes (0 match, 1 mismatch, 2 vertical, 3 horizontal), 16
// to an int32 along the band, laid out [N, S, W/16]: a lane's rows are
// contiguous (16 KiB at S = 512, W = 128).
//
// What bounds them on an H100.  Each lane is a chain of dependent steps (S
// rows for the row walk and the deposit, up to MAXC tape columns for the
// column walk); lanes are independent.  The paths launch 2,300-9,000 lanes,
// so one thread a lane fills 72-282 warps, fewer than the card's 528
// schedulers: a launch takes about one lane's chain, not the bytes.  The
// bytes are small beside it: the moves of the rows a lane walks (32 B a row
// at W = 128) and 12 B a row of output for the row walk; 25 B a row in and
// 9 B a char out for the deposit; one word a tape column and one byte of
// tape for the column walk.  So the designs shorten the chain and keep its
// loads off it:
//
//   * walk_rows, one thread a lane.  A row's exit is the largest column
//     <= w whose move is not horizontal.  The row's words are read in
//     32-cell chunks, each a 64-bit register pair; ~(x & x >> 1) & 0x55..
//     marks the non-horizontal cells, and a masked count of leading zeros
//     finds the exit in each chunk.  No loop over the band and no indexed
//     register array: the exit's code is read from the same register pair.
//     The loads do not depend on the walk, so the thread loads a block of
//     rows ahead of the block it walks (double-buffered), a full 128-byte
//     line a block at W = 128.  About 20 int32 operations a 32-cell chunk
//     and 12 more a row.  Every W % 16 == 0 up to 256 has its instance
//     (rows of 1-16 words; an odd count loads word by word).
//   * walk_deposit, one warp a lane.  The reference slides a W-wide
//     accumulator down the rows; indexed by target char instead of band
//     column, it does not move, and the accumulator is the output row
//     itself, in shared memory.  The deposits commute but for the base
//     channel, where the last writer wins: the scan runs rows descending,
//     so the lowest row wins, and within a row the gap marks come after
//     the consumed base.  So each cell keeps a priority key 2*row + (base ?
//     1 : 0) under atomicMin, the insertion pack takes atomicOr and the
//     count atomicMax, and the warp's 32 threads take 32 rows at once, each
//     row's seven inputs read coalesced across the warp.  A last pass turns
//     the keys into codes and writes the three planes coalesced.  About 24
//     int32 operations a row, 3 a gap cell and 6 an output char.
//   * walk_cols, one thread a lane.  Each step reads the word at its
//     (row, column) through the read-only cache, flat and clipped over the
//     lane as the reference's _read_move does (floor division and modulo
//     by 16 are an arithmetic shift and a mask), and prefetches the word
//     four rows up into L1, where the walk will be a few steps later.  A
//     walk that has ended stays ended, so the thread leaves the loop there
//     and fills the rest of the tape with -1.  Tape bytes are gathered into
//     words and stored 4 at a time when MAXC is a multiple of 4.  About 16
//     int32 operations a step.
//
// Every kernel writes every element of its outputs (the wrapper allocates
// them with torch.empty), reads nothing outside its lane whatever the
// lane's seg_qlen, w_end or row values, and is exact: integers throughout,
// int32 wrap-around where the reference wraps (vbase << 2(d-1), (i-1)*W/16).
//
// Left for later: a warp a lane for the two walks (the row exit as one warp
// reduction), and the row walk inside the move-writing DP kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmecat_walk.so cns_walk.cu
// Bound with ctypes by mecat_tpu_torch/ops/walk_kernel.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVert = 2;                 // ops.align.MOVE_VERT
constexpr int kHoriz = 3;                // ops.align.MOVE_HORIZ
constexpr int kGap = 4;                  // ops.consensus.GAP
constexpr int kMaxD = 15;                // constants.MAX_INS_DELTA
constexpr int kWalkThreads = 32;         // one warp a block: lanes spread
                                         // over every SM
constexpr int kDepositWarps = 4;         // lanes (warps) a deposit block
constexpr int kKeyNone = 0x7fffffff;     // no base deposited at a char
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr uint64_t kEven = 0x5555555555555555ull;

// ---------------------------------------------------------------- row walk

// Rows r0, r0-1, ..., r0-kAhead+1 of a lane (those >= 1) into registers:
// 16-byte loads where a row is a whole number of them, else 8- or 4-byte.
template <int kWp, int kAhead>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ lm,
                                          int r0, uint32_t (&buf)[kAhead][kWp]) {
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    const int rr = r0 - a;
    if (rr >= 1) {
      const uint32_t* p = lm + (size_t)(rr - 1) * kWp;
      if constexpr (kWp % 4 == 0) {
#pragma unroll
        for (int k = 0; k < kWp; k += 4) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + k));
          buf[a][k] = v.x;
          buf[a][k + 1] = v.y;
          buf[a][k + 2] = v.z;
          buf[a][k + 3] = v.w;
        }
      } else if constexpr (kWp % 2 == 0) {
#pragma unroll
        for (int k = 0; k < kWp; k += 2) {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + k));
          buf[a][k] = v.x;
          buf[a][k + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kWp; ++k) buf[a][k] = __ldg(p + k);
      }
    }
  }
}

template <int kW>
__global__ void __launch_bounds__(kWalkThreads)
walk_rows_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ seg_qlen,
                 const int32_t* __restrict__ w_end, int32_t* __restrict__ mv_out,
                 int32_t* __restrict__ h_out, int32_t* __restrict__ wo_out,
                 int32_t* __restrict__ w0_out, int N, int S) {
  constexpr int kWp = kW / 16;           // words a row
  // 32-cell chunks (register pairs); at an odd kWp the last chunk's upper
  // half is empty (cells past W, never left of the walk's column)
  constexpr int kChunks = (kWp + 1) / 2;
  // rows a load block: 32 words in flight, double-buffered
  constexpr int kAhead = 32 / kWp < 8 ? 32 / kWp : 8;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const uint32_t* lm = moves + (size_t)lane * S * kWp;
  int32_t* mvl = mv_out + (size_t)lane * S;
  int32_t* hl = h_out + (size_t)lane * S;
  int32_t* wol = wo_out + (size_t)lane * S;
  const int r_end = seg_qlen[lane];
  // the reference carries the column as a one-hot row; one outside the
  // band is empty and reads as column 0
  int w = w_end[lane];
  if (w < 0 || w >= kW) w = 0;
  int r = S;
  for (; r >= 1 && r > r_end; --r) {     // rows above the walk's start
    mvl[r - 1] = -1;
    hl[r - 1] = 0;
    wol[r - 1] = -1;
  }
  bool alive = true;
  uint32_t cur[kAhead][kWp];
  load_rows<kWp, kAhead>(lm, r, cur);
  while (r >= 1 && alive) {
    uint32_t nxt[kAhead][kWp];
    load_rows<kWp, kAhead>(lm, r - kAhead, nxt);
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int rr = r - a;
      if (rr < 1) break;
      int mv = -1, h = 0, wo = -1;
      if (alive) {
        int w_out = -1;
        int code = 0;
#pragma unroll
        for (int j = kChunks - 1; j >= 0; --j) {
          const uint64_t hi =
              2 * j + 1 < kWp ? cur[a][2 * j + 1 < kWp ? 2 * j + 1 : 0] : 0u;
          const uint64_t raw = (uint64_t)cur[a][2 * j] | (hi << 32);
          const uint64_t not_h = ~(raw & (raw >> 1)) & kEven;
          const int lim = 2 * (w - 32 * j);    // bit of cell w in this chunk
          const uint64_t keep =
              lim < 0 ? 0ull : (lim >= 62 ? ~0ull : (2ull << lim) - 1);
          const uint64_t x = not_h & keep;
          if (w_out < 0 && x != 0) {
            const int bit = 63 - __clzll(x);
            w_out = 32 * j + (bit >> 1);
            code = (int)(raw >> bit) & 3;
          }
        }
        if (w_out >= 0) {
          mv = code;
          h = w - w_out;
          wo = w_out;
          // a vertical move leaves to (r-1, w+1), out of the last column to
          // the empty one-hot, which reads as column 0
          w = code == kVert ? (w_out + 1 < kW ? w_out + 1 : 0) : w_out;
        } else {
          alive = false;                       // the path broke
        }
      }
      mvl[rr - 1] = mv;
      hl[rr - 1] = h;
      wol[rr - 1] = wo;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int k = 0; k < kWp; ++k) cur[a][k] = nxt[a][k];
    r -= kAhead;
  }
  for (; r >= 1; --r) {                  // rows below a broken path
    mvl[r - 1] = -1;
    hl[r - 1] = 0;
    wol[r - 1] = -1;
  }
  w0_out[lane] = w;
}

// ---------------------------------------------------------------- deposit

__global__ void __launch_bounds__(32 * kDepositWarps)
walk_deposit_kernel(const int32_t* __restrict__ wo,
                    const int32_t* __restrict__ aw,
                    const int32_t* __restrict__ h,
                    const int32_t* __restrict__ mv,
                    const int32_t* __restrict__ vbase,
                    const int32_t* __restrict__ delta,
                    const uint8_t* __restrict__ keep_ins,
                    int8_t* __restrict__ val0, int32_t* __restrict__ ipack,
                    int32_t* __restrict__ icnt, int N, int S, int W) {
  extern __shared__ int32_t smem[];
  const int half = W / 2;
  const int LP = S + half - 1;           // output chars of a lane
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kDepositWarps + warp;
  if (lane >= N) return;                 // the whole warp: no block barrier
  const int per_warp = 3 * LP + (S + 3) / 4;
  int32_t* key = smem + (size_t)warp * per_warp;
  int32_t* ap = key + LP;
  int32_t* ac = ap + LP;
  int8_t* vb8 = reinterpret_cast<int8_t*>(ac + LP);
  for (int c = t; c < LP; c += 32) {
    key[c] = kKeyNone;
    ap[c] = 0;
    ac[c] = 0;
  }
  __syncwarp();
  const size_t row0 = (size_t)lane * S;
  for (int i = t; i < S; i += 32) {
    const size_t x = row0 + i;
    const int m = mv[x];
    const int o = wo[x];
    const int vb = vbase[x];
    vb8[i] = (int8_t)vb;                 // the reference's astype(int8)
    const int off = i - half;            // char of band column w: off + w
    if ((m == 0 || m == 1) && o >= 0 && o < W && off + o >= 0)
      atomicMin(&key[off + o], 2 * i + 1);
    if (m >= 0 && o < W - 1) {
      // columns o+1 .. o+h of the band, o + h wrapping as int32 does
      const int hi = (int)((uint32_t)o + (uint32_t)h[x]);
      int lo = o + 1;
      if (lo < -off) lo = -off;          // chars below 0 are dropped
      if (lo < 0) lo = 0;
      const int top = hi < W - 1 ? hi : W - 1;
      for (int w = lo; w <= top; ++w) atomicMin(&key[off + w], 2 * i);
    }
    if (keep_ins[x]) {
      const int d = delta[x];
      const int a = aw[x];
      if (d >= 1 && a >= 0 && a < W && off + a >= 0) {
        if (d <= kMaxD)
          atomicOr(&ap[off + a], (int)((uint32_t)vb << (2 * (d - 1))));
        atomicMax(&ac[off + a], d);
      }
    }
  }
  __syncwarp();
  const size_t out0 = (size_t)lane * LP;
  for (int c = t; c < LP; c += 32) {
    const int k = key[c];
    val0[out0 + c] =
        k == kKeyNone ? (int8_t)-1 : ((k & 1) ? vb8[k >> 1] : (int8_t)kGap);
    ipack[out0 + c] = ap[c];
    icnt[out0 + c] = ac[c];
  }
}

// ---------------------------------------------------------------- col walk

template <bool kAligned>
__global__ void __launch_bounds__(kWalkThreads)
walk_cols_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ seg_qlen,
                 const int32_t* __restrict__ w_end, uint8_t* __restrict__ ops,
                 int32_t* __restrict__ n_cols, int N, int S, int Wp, int half,
                 int maxc) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const uint32_t* lm = moves + (size_t)lane * S * Wp;
  const int last = S * Wp - 1;
  uint8_t* out = ops + (size_t)lane * maxc;
  int i = seg_qlen[lane];
  int w = w_end[lane];
  uint32_t pack = 0;
  // step s emits tape column maxc - 1 - s (the tape is right-aligned)
  auto emit = [&](int s, int v) {
    const int col = maxc - 1 - s;
    if constexpr (kAligned) {
      pack = (pack << 8) | (uint8_t)v;
      if ((col & 3) == 0) *reinterpret_cast<uint32_t*>(out + col) = pack;
    } else {
      out[col] = (uint8_t)v;
    }
  };
  int s = 0;
  for (; s < maxc; ++s) {
    int mv;
    if (i > 0) {
      // flat word index (i-1)*W/16 + floor(w/16), int32 as the reference
      // computes it, clipped to the lane
      int idx = (int)((uint32_t)(i - 1) * (uint32_t)Wp + (uint32_t)(w >> 4));
      idx = idx < 0 ? 0 : (idx > last ? last : idx);
      int ahead = idx - 4 * Wp;
      ahead = ahead < 0 ? 0 : ahead;
      asm volatile("prefetch.global.L1 [%0];" ::"l"(lm + ahead));
      mv = (int)((__ldg(lm + idx) >> (2 * (w & 15))) & 3u);
    } else {
      // leading target deletions at row 0
      mv = (i == 0 && w - half > 0) ? kHoriz : -1;
    }
    if (mv < 0) break;                   // ended, and stays so
    emit(s, mv);
    if (i > 0 && mv != kHoriz) --i;
    w += mv == kVert ? 1 : (mv == kHoriz ? -1 : 0);
  }
  n_cols[lane] = s;
  if constexpr (kAligned) {
    for (; s < maxc && ((maxc - 1 - s) & 3) != 3; ++s) emit(s, -1);
    // tape columns 0 .. maxc-1-s are left: whole words
    for (int c = 0; c < maxc - s; c += 4)
      *reinterpret_cast<uint32_t*>(out + c) = 0xffffffffu;
  } else {
    for (; s < maxc; ++s) emit(s, -1);
  }
}

unsigned blocks_for(int lanes, int per_block) {
  return (unsigned)((lanes + per_block - 1) / per_block);
}

}  // namespace

// moves int32 [N, S, W/16] (16-byte aligned), seg_qlen and w_end int32 [N];
// outputs mv, h, w_out int32 [N, S] and w0 int32 [N], uninitialised: every
// element is written.  All device pointers, row-major, contiguous.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without a launch, for a W that is not a multiple
// of 16 in [16, 256] or an S below 1.
extern "C" int mecat_walk_rows(const void* moves, const void* seg_qlen,
                               const void* w_end, void* mv, void* h, void* wo,
                               void* w0, int N, int S, int W, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(N, kWalkThreads));
  const auto* m = static_cast<const uint32_t*>(moves);
  const auto* q = static_cast<const int32_t*>(seg_qlen);
  const auto* e = static_cast<const int32_t*>(w_end);
  auto* o1 = static_cast<int32_t*>(mv);
  auto* o2 = static_cast<int32_t*>(h);
  auto* o3 = static_cast<int32_t*>(wo);
  auto* o4 = static_cast<int32_t*>(w0);
  switch (W) {
#define MECAT_ROWS_CASE(kW)                                                 \
    case kW:                                                                \
      walk_rows_kernel<kW><<<grid, kWalkThreads, 0, st>>>(m, q, e, o1, o2,  \
                                                          o3, o4, N, S);    \
      break;
    MECAT_ROWS_CASE(16) MECAT_ROWS_CASE(32) MECAT_ROWS_CASE(48)
    MECAT_ROWS_CASE(64) MECAT_ROWS_CASE(80) MECAT_ROWS_CASE(96)
    MECAT_ROWS_CASE(112) MECAT_ROWS_CASE(128) MECAT_ROWS_CASE(144)
    MECAT_ROWS_CASE(160) MECAT_ROWS_CASE(176) MECAT_ROWS_CASE(192)
    MECAT_ROWS_CASE(208) MECAT_ROWS_CASE(224) MECAT_ROWS_CASE(240)
    MECAT_ROWS_CASE(256)
#undef MECAT_ROWS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// wo, aw, h, mv, vbase, delta int32 [N, S] and keep_ins bool [N, S] (rows
// ascending); outputs val0 int8, ipack and icnt int32 [N, S + W/2 - 1],
// uninitialised: every element is written.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue, without a launch, for an odd
// or non-positive W, an S below 1, or an S whose accumulators do not fit
// the block's shared memory.
extern "C" int mecat_walk_deposit(const void* wo, const void* aw,
                                  const void* h, const void* mv,
                                  const void* vbase, const void* delta,
                                  const void* keep_ins, void* val0,
                                  void* ipack, void* icnt, int N, int S,
                                  int W, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || W <= 0 || W % 2) return (int)cudaErrorInvalidValue;
  const size_t LP = (size_t)S + W / 2 - 1;
  const size_t smem =
      (size_t)kDepositWarps * (3 * LP + (S + 3) / 4) * sizeof(int32_t);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_deposit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  walk_deposit_kernel<<<blocks_for(N, kDepositWarps), 32 * kDepositWarps,
                        smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wo), static_cast<const int32_t*>(aw),
      static_cast<const int32_t*>(h), static_cast<const int32_t*>(mv),
      static_cast<const int32_t*>(vbase), static_cast<const int32_t*>(delta),
      static_cast<const uint8_t*>(keep_ins), static_cast<int8_t*>(val0),
      static_cast<int32_t*>(ipack), static_cast<int32_t*>(icnt), N, S, W);
  return (int)cudaGetLastError();
}

// moves int32 [N, S, W/16], seg_qlen and w_end int32 [N]; outputs ops int8
// [N, max_cols] (the tape, right-aligned, -1 before it) and n_cols int32
// [N], uninitialised: every element is written.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue, without a launch, for a W that
// is not a positive multiple of 16, an S below 1 or max_cols below 1.
extern "C" int mecat_walk_cols(const void* moves, const void* seg_qlen,
                               const void* w_end, void* ops, void* n_cols,
                               int N, int S, int W, int max_cols,
                               void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || W <= 0 || W % 16 || max_cols <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(N, kWalkThreads));
  const auto* m = static_cast<const uint32_t*>(moves);
  const auto* q = static_cast<const int32_t*>(seg_qlen);
  const auto* e = static_cast<const int32_t*>(w_end);
  auto* o = static_cast<uint8_t*>(ops);
  auto* n = static_cast<int32_t*>(n_cols);
  if (max_cols % 4 == 0)
    walk_cols_kernel<true><<<grid, kWalkThreads, 0, st>>>(
        m, q, e, o, n, N, S, W / 16, W / 2, max_cols);
  else
    walk_cols_kernel<false><<<grid, kWalkThreads, 0, st>>>(
        m, q, e, o, n, N, S, W / 16, W / 2, max_cols);
  return (int)cudaGetLastError();
}
