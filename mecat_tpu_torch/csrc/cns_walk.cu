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
// column walk); lanes are independent.  The paths launch 2,300-9,000 lanes.
// The bytes: the moves of the rows a lane walks (32 B a row at W = 128) and
// 12 B a row of output for the row walk; 25 B a row in and 9 B a char out
// for the deposit; one word a tape column and one byte of tape for the
// column walk.  At 4,096 lanes of (S, W) = (512, 128) the row walk's and
// the deposit's bytes take about 0.02 ms at 3.35 TB/s, a lane's chain of
// 512 steps about as long at 40 ns a step: so each design keeps device
// memory off the chain, keeps enough lanes resident to hide the chain, and
// moves its bytes in whole sectors.
//
//   * walk_rows, one warp walks 32 lanes, a thread a lane, and a second
//     warp of the block copies their rows.  A lane's chain is the whole
//     cost (on an H100 a lone warp's step was the same at 32 and at 4,096
//     lanes), so a step does as little as it can and nothing else waits in
//     it.  A row's exit is the highest non-horizontal cell <= w: in w's own
//     word j up to w (~(x & x >> 1) & 0x55.. marks a word's non-horizontal
//     cells, a shift keeps those <= w), else in word j - 1, both read from
//     shared memory at once; only a run of horizontal moves through the
//     whole of word j - 1 (or a broken path) searches the lower words one
//     by one.  A count of leading zeros gives the cell, a shift its code;
//     the rest is selects, no branch.  About 20 dependent operations and
//     one shared-memory load a step.  The copying warp streams each lane's
//     rows (contiguous in device memory) into the lane's ring of 32 rows in
//     shared memory, 8 rows at a time with one bulk copy of the Tensor
//     Memory Accelerator a lane (4-byte cp.async where a lane's block is
//     not 16-byte aligned), three groups ahead of the walk; an mbarrier a
//     stage says a group has landed (full) and that the walk has left it
//     (empty).  Issued by the walking warp itself, the copies of 32 lanes'
//     blocks 16 KB apart took a large share of its time on an H100; from
//     the second warp they overlap the walk.  The walk holds a group's 8
//     rows of (mv, h, w_out) in registers and stores each array as two
//     16-byte words a lane (word by word where S % 4 != 0); gathering 32
//     rows in shared memory to store whole lines was slower.  The warp
//     walks its lanes in step from the highest row any of them starts at;
//     rows above that are written up front, and once every lane of the warp
//     has broken (or never started) the rest is written without walking
//     and the copying warp stops copying.  33 KB of shared memory a block
//     at W = 128 (131 KB at W = 512), one block an SM at 4,096 lanes.  The
//     work counted for the bound is the old one-thread design's, about 20
//     int32 operations a 32-cell chunk and 12 a row.
//   * walk_deposit, one warp a lane.  The reference slides a W-wide
//     accumulator down the rows; indexed by target char instead of band
//     column, it does not move, and the accumulator is the output row
//     itself, in shared memory.  The deposits commute but for the base
//     channel, where the last writer wins: the scan runs rows descending,
//     so the lowest row wins, and within a row the gap marks come after
//     the consumed base.  So each cell keeps a priority key, (2*row + (base
//     ? 1 : 0)) << 8 with the base's byte below it, under atomicMin (no
//     byte array beside it), the insertion pack takes atomicOr and the
//     count atomicMax, and the warp's 32 threads take 32 rows at once, each
//     row's seven inputs read coalesced across the warp.  The inputs of the
//     next two passes of 32 rows are in flight in registers while a pass
//     deposits (the first two before the accumulators are initialised), so
//     a lane waits for device memory about once, not S/32 times.  The gap
//     marks of a pass are shared out over the warp: a prefix sum of the 32
//     rows' cell counts (__shfl_up_sync), then each thread takes every 32nd
//     cell and finds its row by a binary search over the sums, so the warp
//     issues (cells)/32 rounds, not max(h).  The accumulators are placed so
//     that the lane's output chars meet 16-byte words in both memories: a
//     last pass writes 4 chars a thread (a 4-byte store of val0, 16-byte
//     stores of ipack and icnt), the unaligned head and tail char by char.
//     Up to 8 warps a block, 7 KB a warp at (512, 128): 32 lanes an SM, so
//     4,096 lanes in one wave.  About 24 int32 operations a row, 3 a gap
//     cell and 6 an output char.
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
// Left for later: the column walk's redesign, and the row walk inside the
// move-writing DP kernel.
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
constexpr int kMaxW = 512;               // the row walk's widest band
constexpr int kWalkThreads = 32;         // column walk: one warp a block,
                                         // lanes spread over every SM
constexpr int kRowRing = 32;             // rows of moves a row-walk thread
                                         // holds
constexpr int kRowLoad = 8;              // rows a copy group, and rows of
                                         // output a thread holds
constexpr int kRowStages = kRowRing / kRowLoad;
constexpr int kDepositWarps = 8;         // lanes (warps) a deposit block, at
                                         // most
constexpr int kKeyNone = 0x7fffffff;     // no base deposited at a char
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemLimit = 227 * 1024;

static_assert(kRowRing % kRowLoad == 0, "copy groups tile the ring");
static_assert((kRowRing & (kRowRing - 1)) == 0,
              "rows index the ring by a mask");

// Lets `kernel` take up to kSmemLimit bytes of dynamic shared memory (once a
// process; the default is 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= kSmemDefault || *done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  *done = err == cudaSuccess;
  return err;
}

unsigned blocks_for(int lanes, int per_block) {
  return (unsigned)((lanes + per_block - 1) / per_block);
}

// ---------------------------------------------------------------- row walk

// The row walk's copies: a bulk copy by the Tensor Memory Accelerator,
// or 4-byte cp.async where a block is not 16-byte aligned, each reporting
// to an mbarrier in shared memory (all addresses are shared-window ones).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives once the bytes given are in: a bulk copy of them follows.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void copy_bulk(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void copy_word(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Arrives once this thread's cp.async copies so far are in.
__device__ __forceinline__ void copy_words_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Words of one thread's ring of a band of W: kRowRing rows of the W/16
// words, then 4 more, so that the 32 threads' rings start 4 banks apart
// (and 16-byte aligned, for the copies).
__host__ __device__ constexpr int row_stride(int W) {
  return kRowRing * (W / 16) + 4;
}

// Bytes of shared memory a row-walk block takes: two mbarriers a stage of
// the ring and the stop word (kRowHead), then the 32 lanes' rings.
constexpr int kRowHead = 16 * kRowStages + 16;
__host__ __device__ constexpr size_t row_smem(int W) {
  return kRowHead + 4 * 32 * (size_t)row_stride(W);
}

// (-1, 0, -1) at rows [lo, hi) of one lane's three outputs.
__device__ __forceinline__ void rows_unvisited(int32_t* mv, int32_t* h,
                                               int32_t* wo, int lo, int hi) {
  for (int i = lo; i < hi; ++i) {
    mv[i] = -1;
    h[i] = 0;
    wo[i] = -1;
  }
}

// Rows [lo, lo + n) of one output array from a thread's registers: two
// 16-byte stores where the rows are 16-byte words (n is 4 or 8 there).
__device__ __forceinline__ void rows_store(int32_t* dst, const int* v, int lo,
                                           int n, bool vec) {
  static_assert(kRowLoad == 8, "two 16-byte words a group");
  if (vec) {
    reinterpret_cast<int4*>(dst + lo)[0] = make_int4(v[0], v[1], v[2], v[3]);
    if (n > 4)
      reinterpret_cast<int4*>(dst + lo)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kRowLoad; ++k)
      if (k < n) dst[lo + k] = v[k];
  }
}

// Non-horizontal cells of a word of moves: the low bit of each 2-bit cell
// whose code is not 3.
__device__ __forceinline__ uint32_t not_horizontal(uint32_t x) {
  return ~(x & (x >> 1)) & 0x55555555u;
}

__global__ void __launch_bounds__(64)
walk_rows_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ seg_qlen,
                 const int32_t* __restrict__ w_end, int32_t* __restrict__ mv_out,
                 int32_t* __restrict__ h_out, int32_t* __restrict__ wo_out,
                 int32_t* __restrict__ w0_out, int N, int S, int W) {
  extern __shared__ uint4 smem_rows[];
  const int t = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;  // warp 0 walks, warp 1 copies
  const int lane = blockIdx.x * 32 + t;  // of both warps' thread t
  const bool live = lane < N;            // a lane past N walks nothing
  const int NW = W >> 4;                 // words a row
  // full[st], empty[st]: an mbarrier each a stage of the ring; then a word
  // the walking warp sets when it stops early; then the 32 lanes' rings
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem_rows);
  auto full = [&](int c) { return bars + 8 * (c & (kRowStages - 1)); };
  auto empty = [&](int c) {
    return bars + 8 * kRowStages + 8 * (c & (kRowStages - 1));
  };
  volatile int* stop = reinterpret_cast<volatile int*>(
      reinterpret_cast<uint64_t*>(smem_rows) + 2 * kRowStages);
  const uint32_t* ring = reinterpret_cast<const uint32_t*>(smem_rows) +
                         kRowHead / 4 + t * row_stride(W);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRowStages; ++st) {
      mbar_init(full(st), 32);
      mbar_init(empty(st), 32);
    }
    *stop = 0;
  }
  __syncthreads();
  const size_t o0 = (size_t)(live ? lane : 0) * S;
  const int rows = live ? min(max(seg_qlen[lane], 0), S) : 0;  // walked
  // the warps walk (and copy) rows i_hi - 1 .. 0 in groups of 8; rows above
  // are no lane's
  const int top = __reduce_max_sync(kFull, (unsigned)rows);
  const int i_hi = min(S, (top + kRowLoad - 1) / kRowLoad * kRowLoad);
  const int c_hi = (i_hi + kRowLoad - 1) / kRowLoad - 1;
  // group c is the stage's use (c_hi - c) / kRowStages: its phase parity
  auto parity = [&](int c) {
    return (uint32_t)((c_hi - c) / kRowStages) & 1u;
  };

  if (!walker) {
    // Copy group c: the lane's rows 8c .. 8c + 7 (those below S), one block
    // of device memory, into lane t's ring once the walk has left the
    // stage's previous group: a bulk copy where the block is 16-byte
    // aligned, else 4-byte cp.async.  A lane that walks none of them, or
    // any once the walk has stopped, only arrives.
    const uint32_t* lm = moves + o0 * NW;
    const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
    const bool bulk = (S * NW) % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(moves) & 15) == 0;
    for (int c = c_hi; c >= 0; --c) {
      if (c_hi - c >= kRowStages) mbar_wait(empty(c), parity(c) ^ 1u);
      if (rows <= c * kRowLoad || *stop) {
        mbar_arrive(full(c));
        continue;
      }
      const int n = min(kRowLoad, S - c * kRowLoad) * NW;  // words
      const uint32_t dst =
          ring_s + 4 * kRowLoad * NW * (c & (kRowStages - 1));
      const uint32_t* src = lm + (size_t)c * kRowLoad * NW;
      if (bulk) {
        mbar_expect(full(c), 4 * n);
        copy_bulk(dst, src, 4 * n, full(c));
      } else {
        for (int u = 0; u < n; ++u) copy_word(dst + 4 * u, src + u);
        copy_words_arrive(full(c));
      }
    }
    return;
  }

  int32_t* out[3] = {mv_out + o0, h_out + o0, wo_out + o0};
  // the reference carries the column as a one-hot row; one outside the
  // band is empty and reads as column 0
  int w = live ? w_end[lane] : 0;
  if (w < 0 || w >= W) w = 0;
  if (live) rows_unvisited(out[0], out[1], out[2], i_hi, S);
  // 16-byte stores where a lane's groups of rows are 16-byte words
  const bool vout = (S & 3) == 0 &&
                    ((reinterpret_cast<uintptr_t>(mv_out) |
                      reinterpret_cast<uintptr_t>(h_out) |
                      reinterpret_cast<uintptr_t>(wo_out)) & 15) == 0;
  bool alive = true;
  for (int c = c_hi; c >= 0; --c) {
    mbar_wait(full(c), parity(c));       // group c has landed
    // Rows past S (the top group where S % 8 != 0) and rows at or above the
    // lane's seg_qlen are walked on whatever the ring holds and written as
    // unvisited.
    int res[3][kRowLoad];                // mv, h, w_out of the group's rows
#pragma unroll
    for (int k = kRowLoad - 1; k >= 0; --k) {
      const int i = c * kRowLoad + k;
      const uint32_t* r = ring + NW * (i & (kRowRing - 1));
      // The exit is the highest non-horizontal cell <= w: in w's own word
      // j up to w, else in word j - 1, both read at once; else (horizontal
      // moves through the whole of word j - 1, or a broken path) a search
      // down the lower words.
      const int j = w >> 4;
      const uint32_t x1 = r[j];
      const uint32_t x0 = r[j > 0 ? j - 1 : 0];
      const uint32_t y1 =
          not_horizontal(x1) & (0xffffffffu >> (30 - 2 * (w & 15)));
      const uint32_t y0 = j > 0 ? not_horizontal(x0) : 0u;
      uint32_t x = y1 ? x1 : x0;
      uint32_t y = y1 ? y1 : y0;
      int q = y1 ? j : j - 1;
      const bool act = alive && i < rows;
      if (act && !y) {
        for (int u = j - 2; u >= 0; --u) {
          const uint32_t xu = r[u];
          if (not_horizontal(xu)) {
            x = xu;
            y = not_horizontal(xu);
            q = u;
            break;
          }
        }
      }
      const int bit = (31 - __clz(y)) & 31;  // even: a cell's low bit
      const int col = 16 * q + (bit >> 1);
      const int code = (int)((x >> bit) & 3u);
      const bool found = act && y != 0u;
      res[0][k] = found ? code : -1;
      res[1][k] = found ? w - col : 0;
      res[2][k] = found ? col : -1;
      // a vertical move leaves to (r-1, w+1), out of the last column to the
      // empty one-hot, which reads as column 0
      const int w_next = code == kVert ? (col + 1 < W ? col + 1 : 0) : col;
      w = found ? w_next : w;
      alive = alive && !(act && !y);     // the path broke
    }
    mbar_arrive(empty(c));               // the stage is free again
    const int lo = c * kRowLoad;
    if (live) {
      const int n = min(kRowLoad, i_hi - lo);
#pragma unroll
      for (int a = 0; a < 3; ++a) rows_store(out[a], res[a], lo, n, vout);
    }
    if (lo > 0 && !__any_sync(kFull, live && alive && rows > 0)) {
      // Every lane of the warp has broken or never started: the rest is
      // unvisited.  The copying warp stops copying; the groups it has
      // issued land before the block exits.
      if (t == 0) *stop = 1;
      if (live) rows_unvisited(out[0], out[1], out[2], 0, lo);
      for (int c2 = c - 1; c2 >= 0; --c2) {
        mbar_wait(full(c2), parity(c2));
        mbar_arrive(empty(c2));
      }
      break;
    }
  }
  if (live) w0_out[lane] = w;
}

// ---------------------------------------------------------------- deposit

// One row of the deposit's inputs, in registers.
struct DepositRow {
  int wo, aw, h, mv, vbase, delta, keep;
};

// Words of each accumulator in a warp's share of shared memory: LP chars
// placed up to 3 words in, rounded up to whole 16-byte words.
__host__ __device__ inline int deposit_stride(int LP) {
  return (LP + 3 + 3) & ~3;
}

__global__ void __launch_bounds__(32 * kDepositWarps, 4)
walk_deposit_kernel(const int32_t* __restrict__ wo,
                    const int32_t* __restrict__ aw,
                    const int32_t* __restrict__ h,
                    const int32_t* __restrict__ mv,
                    const int32_t* __restrict__ vbase,
                    const int32_t* __restrict__ delta,
                    const uint8_t* __restrict__ keep_ins,
                    int8_t* __restrict__ val0, int32_t* __restrict__ ipack,
                    int32_t* __restrict__ icnt, int N, int S, int W) {
  extern __shared__ uint4 smem_dep[];
  const int half = W / 2;
  const int LP = S + half - 1;           // output chars of a lane
  const int P = deposit_stride(LP);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lane >= N) return;                 // the whole warp: no block barrier
  const size_t row0 = (size_t)lane * S;
  const size_t out0 = (size_t)lane * LP;
  // char c of the lane sits at word sh + c of its accumulators, so that a
  // 16-byte word of output chars is one in shared memory too
  const int sh = (int)(out0 & 3);
  int32_t* acc = reinterpret_cast<int32_t*>(smem_dep) + (size_t)warp * 3 * P;
  int32_t* key = acc + sh;
  int32_t* ap = acc + P + sh;
  int32_t* ac = acc + 2 * P + sh;

  auto load = [&](DepositRow& r, const int i) {
    if (i < S) {
      const size_t x = row0 + i;
      r.wo = wo[x];
      r.aw = aw[x];
      r.h = h[x];
      r.mv = mv[x];
      r.vbase = vbase[x];
      r.delta = delta[x];
      r.keep = keep_ins[x];
    }
  };
  // the first two passes' rows are in flight while the accumulators are set
  DepositRow cur{}, nxt{};
  load(cur, t);
  load(nxt, 32 + t);
  for (int u = t; u < 3 * P / 4; u += 32)
    reinterpret_cast<int4*>(acc)[u] =
        u < P / 4 ? make_int4(kKeyNone, kKeyNone, kKeyNone, kKeyNone)
                  : make_int4(0, 0, 0, 0);
  __syncwarp();

  for (int i0 = 0; i0 < S; i0 += 32) {
    const DepositRow r = cur;
    cur = nxt;
    load(nxt, i0 + 64 + t);              // two passes ahead
    const int i = i0 + t;
    int n = 0, first = 0, gap_key = 0;   // this row's gap marks
    if (i < S) {
      const int off = i - half;          // char of band column w: off + w
      if ((r.mv == 0 || r.mv == 1) && r.wo >= 0 && r.wo < W && off + r.wo >= 0)
        // the reference's astype(int8) of vbase is the key's low byte
        atomicMin(&key[off + r.wo], ((2 * i + 1) << 8) | (r.vbase & 0xff));
      if (r.mv >= 0 && r.wo < W - 1) {
        // columns wo+1 .. wo+h of the band, wo + h wrapping as int32 does
        const int hi = (int)((uint32_t)r.wo + (uint32_t)r.h);
        int lo = r.wo + 1;
        if (lo < -off) lo = -off;        // chars below 0 are dropped
        if (lo < 0) lo = 0;
        const int top = hi < W - 1 ? hi : W - 1;
        if (top >= lo) {
          n = top - lo + 1;
          first = off + lo;
          gap_key = (2 * i) << 8;
        }
      }
      if (r.keep) {
        const int d = r.delta;
        const int a = r.aw;
        if (d >= 1 && a >= 0 && a < W && off + a >= 0) {
          if (d <= kMaxD)
            atomicOr(&ap[off + a], (int)((uint32_t)r.vbase << (2 * (d - 1))));
          atomicMax(&ac[off + a], d);
        }
      }
    }
    // the pass's gap cells, numbered across the warp: row t holds cells
    // [incl - n, incl); cell c of it is char first + c - (incl - n)
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (t >= d) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int base = first - (incl - n);
    for (int c0 = 0; c0 < total; c0 += 32) {
      const int c = c0 + t;
      int row = 0;                       // rows whose cells end at or below c
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, incl, row + step - 1) <= c) row += step;
      }
      row &= 31;                         // 32 only where c >= total
      const int ch = __shfl_sync(kFull, base, row) + c;
      const int k = __shfl_sync(kFull, gap_key, row);
      if (c < total) atomicMin(&key[ch], k);
    }
  }
  __syncwarp();

  // the planes: 4 chars a thread where they fill a 16-byte word
  auto code = [](const int k) -> uint32_t {
    const int v = k == kKeyNone ? -1 : (((k >> 8) & 1) ? (int8_t)(k & 0xff)
                                                       : kGap);
    return (uint32_t)(uint8_t)(int8_t)v;
  };
  auto put = [&](const int c) {
    val0[out0 + c] = (int8_t)code(key[c]);
    ipack[out0 + c] = ap[c];
    icnt[out0 + c] = ac[c];
  };
  const int head = min((4 - sh) & 3, LP);
  const int nvec = (LP - head) / 4;
  const int tail = head + 4 * nvec;
  if (t < head) put(t);
  if (tail + t < LP) put(tail + t);
  for (int u = t; u < nvec; u += 32) {
    const int c = head + 4 * u;
    const int4 k = *reinterpret_cast<const int4*>(key + c);
    *reinterpret_cast<uint32_t*>(val0 + out0 + c) =
        code(k.x) | code(k.y) << 8 | code(k.z) << 16 | code(k.w) << 24;
    *reinterpret_cast<int4*>(ipack + out0 + c) =
        *reinterpret_cast<const int4*>(ap + c);
    *reinterpret_cast<int4*>(icnt + out0 + c) =
        *reinterpret_cast<const int4*>(ac + c);
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

}  // namespace

// moves int32 [N, S, W/16], seg_qlen and w_end int32 [N]; outputs mv, h,
// w_out int32 [N, S] and w0 int32 [N], uninitialised: every element is
// written.  All device pointers, row-major, contiguous.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without a launch, for a W that is not a multiple
// of 16 in [16, 512] or an S below 1.
extern "C" int mecat_walk_rows(const void* moves, const void* seg_qlen,
                               const void* w_end, void* mv, void* h, void* wo,
                               void* w0, int N, int S, int W, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || W <= 0 || W % 16 || W > kMaxW)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  const size_t smem = row_smem(W);
  const cudaError_t err = allow_smem(walk_rows_kernel, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  walk_rows_kernel<<<blocks_for(N, 32), 64, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(moves),
      static_cast<const int32_t*>(seg_qlen),
      static_cast<const int32_t*>(w_end), static_cast<int32_t*>(mv),
      static_cast<int32_t*>(h), static_cast<int32_t*>(wo),
      static_cast<int32_t*>(w0), N, S, W);
  return (int)cudaGetLastError();
}

// wo, aw, h, mv, vbase, delta int32 [N, S] and keep_ins bool [N, S] (rows
// ascending); outputs val0 int8, ipack and icnt int32 [N, S + W/2 - 1],
// uninitialised: every element is written; ipack and icnt 16-byte aligned,
// val0 4-byte aligned (as torch.empty gives them).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue, without a
// launch, for an odd or non-positive W, an S below 1, misaligned outputs,
// or an S whose accumulators do not fit the block's shared memory for one
// lane.
extern "C" int mecat_walk_deposit(const void* wo, const void* aw,
                                  const void* h, const void* mv,
                                  const void* vbase, const void* delta,
                                  const void* keep_ins, void* val0,
                                  void* ipack, void* icnt, int N, int S,
                                  int W, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || W <= 0 || W % 2) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(ipack) |
        reinterpret_cast<uintptr_t>(icnt)) & 15) ||
      (reinterpret_cast<uintptr_t>(val0) & 3))
    return (int)cudaErrorInvalidValue;
  const size_t per_lane =
      3 * (size_t)deposit_stride(S + W / 2 - 1) * sizeof(int32_t);
  if (per_lane > kSmemLimit) return (int)cudaErrorInvalidValue;
  // as many lanes a block as fit, up to kDepositWarps
  const int warps = (int)(kSmemLimit / per_lane) < kDepositWarps
                        ? (int)(kSmemLimit / per_lane)
                        : kDepositWarps;
  static bool smem_set = false;
  const cudaError_t err =
      allow_smem(walk_deposit_kernel, warps * per_lane, &smem_set);
  if (err != cudaSuccess) return (int)err;
  walk_deposit_kernel<<<blocks_for(N, warps), 32 * warps, warps * per_lane,
                        static_cast<cudaStream_t>(stream)>>>(
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
