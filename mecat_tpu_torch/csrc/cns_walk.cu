// The three device scans of correction and mapping, one launch each.
//
// The JAX package runs each of them as a lax.scan that XLA compiles into one
// device loop; the port's plain versions are Python loops of small torch ops
// (one launch per op per step).  Here each is one kernel:
//
//   * walk_rows (entry mecat_walk_rows) replaces the row walk
//     mecat_tpu/ops/align.py:traceback_rows (scan at :354), plain version
//     ops/align.traceback_rows_plain;
//   * walk_deposit (entry mecat_walk_deposit_rows) replaces both
//     directions' row information, mecat_tpu/ops/consensus_banded.py:
//     direction_rowinfo (:141), and the sliding-band deposit _deposit_scan
//     (:87, scan at :128) of _planes_from_rowinfo, plain version
//     ops/consensus_banded.plane_inputs_plain (direction_rowinfo, then
//     deposit_scan_plain);
//   * walk_cols (entry mecat_walk_cols) replaces the column walk
//     mecat_tpu/ops/align.py:traceback_ops (scan at :283), plain version
//     ops/align.traceback_ops_plain.
//
// Moves are 2-bit codes (0 match, 1 mismatch, 2 vertical, 3 horizontal), 16
// to an int32 along the band, laid out [N, S, W/16]: a lane's rows are
// contiguous (16 KiB at S = 512, W = 128).
//
// What bounds them on an H100.  Each lane is a chain of dependent steps (S
// rows for the row walk and the deposit, up to seg_qlen row steps for the
// column walk); lanes are independent.  The paths launch 2,300-9,000 lanes.
// The bytes: the moves of the rows a lane walks (32 B a row at W = 128) and
// 12 B a row of output for the row walk; 13 B a row in (mv, h, wo and
// the query char) and 9 B a char out for the deposit, 16 B a lane of side
// arrays; one word a tape column and one byte of tape for the
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
//     at W = 128 (131 KB at W = 512), one block an SM at 4,096 lanes.  A
//     lane's ring is 32 rows of W/16 words, so past W = 512 a block walks
//     fewer lanes (16 up to W = 1024, 8 up to 3,616: 197 KB at 3072; 4 up
//     to 7,248, 2 up to 14,512, then 1: 197 KB at 24,576), the other
//     threads of both warps idle.  The work counted for the bound is the
//     old one-thread design's, about 20 int32 operations a 32-cell chunk
//     and 12 a row.
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
//     row's walk outputs (mv, h, wo) and its query char read coalesced
//     across the warp.  The row information the deposit needs is made in
//     the same pass, as direction_rowinfo makes it with some 140 small
//     torch ops a chunk: the query char (one contiguous slice of the
//     pair's support row a segment, flipped on a left lane, its start
//     wrapped and clamped as lax.dynamic_slice's), each VERT row's place
//     in its run (run_deltas) and the side-band runs (j == 0 on a right
//     lane, j == j_end on a left one) that go to the side arrays.  A run
//     may cross a pass, so a right lane's passes go up the rows, a warp
//     max-scan of run starts carrying the last start, and a left lane's go
//     down them, a min-scan of run ends carrying the first end; a left
//     lane's j_end (a max over every visited row) is one reduction pass
//     over its rows first.  The side arrays are warp reductions
//     (__reduce_max_sync, __reduce_or_sync); a lane that is not ok
//     deposits nothing and skips its passes.  The inputs of the
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
//     4,096 lanes in one wave (18 KB a warp at (512, 2048), 25 KB at (512,
//     3072): 8 warps a block still; 150 KB at (512, 24576): one).  About 24
//     int32 operations a row for the deposit and 40 for its row
//     information (three warp scans), 3 a gap cell and 6 an output char.
//   * walk_cols, the row walk's machinery: a walking warp of 32 lanes, a
//     thread a lane, and a copying warp that streams each lane's rows,
//     descending, into the same ring.  The column walk visits its rows in
//     the same order, one non-horizontal move a row, so it steps a row,
//     not a column: at row i and column w the row's exit is the highest
//     non-horizontal cell <= w (the row walk's two-word test and count of
//     leading zeros), and the step emits the row's run of w - exit
//     horizontal codes, then the exit code, into the lane's tape,
//     backwards from column MAXC - 1.  The lanes walk in step, row by row,
//     each on the rows below its seg_qlen, so a chain is at most seg_qlen
//     row steps and its common step reads shared memory only.  The
//     reference reads a lane's moves as one flat vector, clipped to the
//     lane (_read_move), so a horizontal run past column 0 goes on into the
//     row below from its top, a vertical move out of column W - 1 reads the
//     next row's word 0, row 1 with w < 0 reads word 0 again and again, and
//     seg_qlen > S starts on the lane's last word: each of those (rare on a
//     DP's moves) is a slow step that reads the words from device memory,
//     flat and clipped (floor division and modulo by 16 are an arithmetic
//     shift and a mask).  Row 0 then emits its leading target deletions
//     while w - W/2 > 0; the walk stops after exactly MAXC columns, in the
//     middle of a row if it must.  The tape bytes are held in a register and
//     stored as whole words (byte by byte only in a word shared with a
//     neighbouring lane's tape, where MAXC % 4 != 0).  The common step (the
//     exit in w's word or the one below, a run of at most 3, room on the
//     tape) is branch-free; a lane whose step is another stops there, and
//     after each group of 8 rows one vote sends such lanes through the full
//     step for the rest of the group.  The work counted for the bound is
//     the old one-thread design's, about 16 int32 operations a tape
//     column.
//
// Every kernel writes every element of its outputs (the wrapper allocates
// them with torch.empty), reads nothing outside its lane whatever the
// lane's seg_qlen, w_end or row values, and is exact: integers throughout,
// int32 wrap-around where the reference wraps (vbase << 2(d-1), (i-1)*W/16).
//
// Left for later: the row walk inside the move-writing DP kernel.
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
constexpr int kMaxW = 24576;             // the widest band (as the DP
                                         // kernels', csrc/dp_segment.cu)
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

// Bytes of shared memory a row-walk (or column-walk) block of L lanes
// takes: two mbarriers a stage of the ring and the stop word (kRowHead),
// then the L lanes' rings.
constexpr int kRowHead = 16 * kRowStages + 16;
__host__ __device__ constexpr size_t row_smem(int W, int L) {
  return kRowHead + 4 * (size_t)L * row_stride(W);
}

// Lanes a row-walk block walks at band W: 32 where their rings fit the
// block's shared memory (W <= 512), else the most of 16, 8, ... that fit.
int row_lanes(int W) {
  int L = 32;
  while (L > 1 && row_smem(W, L) > kSmemLimit) L >>= 1;
  return L;
}

// The ring of a row-walk block, as both of its warps see it: an mbarrier
// pair a stage, the stop word and thread t's lane's ring; groups of
// kRowLoad rows c_hi .. 0, walked (and copied) descending.
struct RowRing {
  uint32_t bars;             // shared-window address of full[0]
  volatile int* stop;        // set by the walking warp when it stops early
  const uint32_t* ring;      // the ring of this thread's lane
  int i_hi;                  // rows i_hi .. S - 1 are no lane's
  int c_hi;
  __device__ uint32_t full(int c) const {
    return bars + 8 * (c & (kRowStages - 1));
  }
  __device__ uint32_t empty(int c) const {
    return bars + 8 * kRowStages + 8 * (c & (kRowStages - 1));
  }
  // group c is the stage's use (c_hi - c) / kRowStages: its phase parity
  __device__ uint32_t parity(int c) const {
    return (uint32_t)((c_hi - c) / kRowStages) & 1u;
  }
};

// Sets up the block's ring (a block barrier): `rows` is the number of rows
// thread t's lane walks, t < L the block's lanes.
__device__ __forceinline__ RowRing row_ring(uint4* smem, const int t,
                                            const int L, const int W,
                                            const int S, const int rows) {
  RowRing rr;
  rr.bars = (uint32_t)__cvta_generic_to_shared(smem);
  rr.stop = reinterpret_cast<volatile int*>(reinterpret_cast<uint64_t*>(smem) +
                                            2 * kRowStages);
  // a thread past the block's lanes reads lane 0's ring, and nothing of it
  // is used
  rr.ring = reinterpret_cast<const uint32_t*>(smem) + kRowHead / 4 +
            (t < L ? t : 0) * row_stride(W);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRowStages; ++st) {
      mbar_init(rr.full(st), 32);
      mbar_init(rr.empty(st), 32);
    }
    *rr.stop = 0;
  }
  __syncthreads();
  const int top = __reduce_max_sync(kFull, (unsigned)rows);
  rr.i_hi = min(S, (top + kRowLoad - 1) / kRowLoad * kRowLoad);
  rr.c_hi = (rr.i_hi + kRowLoad - 1) / kRowLoad - 1;
  return rr;
}

// The copying warp: copy group c, the lane's rows 8c .. 8c + 7 (those below
// S), one block of device memory, into the lane's ring once the walk has
// left the stage's previous group: a bulk copy where the block is 16-byte
// aligned, else 4-byte cp.async.  A lane that walks none of them, or any
// once the walk has stopped, only arrives.
__device__ __forceinline__ void copy_rows_ahead(const RowRing& rr,
                                                const uint32_t* lm,
                                                const int rows, const int S,
                                                const int NW, bool bulk) {
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(rr.ring);
  for (int c = rr.c_hi; c >= 0; --c) {
    if (rr.c_hi - c >= kRowStages) mbar_wait(rr.empty(c), rr.parity(c) ^ 1u);
    if (rows <= c * kRowLoad || *rr.stop) {
      mbar_arrive(rr.full(c));
      continue;
    }
    const int n = min(kRowLoad, S - c * kRowLoad) * NW;  // words
    const uint32_t dst = ring_s + 4 * kRowLoad * NW * (c & (kRowStages - 1));
    const uint32_t* src = lm + (size_t)c * kRowLoad * NW;
    if (bulk) {
      mbar_expect(rr.full(c), 4 * n);
      copy_bulk(dst, src, 4 * n, rr.full(c));
    } else {
      for (int u = 0; u < n; ++u) copy_word(dst + 4 * u, src + u);
      copy_words_arrive(rr.full(c));
    }
  }
}

// The walking warp stops before group c: the copying warp stops copying,
// and the groups it has issued land before the block exits.
__device__ __forceinline__ void stop_walking(const RowRing& rr, const int c,
                                             const int t) {
  if (t == 0) *rr.stop = 1;
  for (int c2 = c - 1; c2 >= 0; --c2) {
    mbar_wait(rr.full(c2), rr.parity(c2));
    mbar_arrive(rr.empty(c2));
  }
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

// Whether a block of a lane's rows can be copied by the Tensor Memory
// Accelerator: a lane's rows start on 16-byte boundaries.
__device__ __forceinline__ bool bulk_rows(const uint32_t* moves, int S,
                                          int NW) {
  return (S * NW) % 4 == 0 && (reinterpret_cast<uintptr_t>(moves) & 15) == 0;
}

__global__ void __launch_bounds__(64)
walk_rows_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ seg_qlen,
                 const int32_t* __restrict__ w_end, int32_t* __restrict__ mv_out,
                 int32_t* __restrict__ h_out, int32_t* __restrict__ wo_out,
                 int32_t* __restrict__ w0_out, int N, int S, int W, int L) {
  extern __shared__ uint4 smem_rows[];
  const int t = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;  // warp 0 walks, warp 1 copies
  const int lane = blockIdx.x * L + t;   // of both warps' thread t
  const bool live = t < L && lane < N;   // a thread past them walks nothing
  const int NW = W >> 4;                 // words a row
  const size_t o0 = (size_t)(live ? lane : 0) * S;
  const int rows = live ? min(max(seg_qlen[lane], 0), S) : 0;  // walked
  // the warps walk (and copy) rows i_hi - 1 .. 0 in groups of 8; rows above
  // are no lane's
  const RowRing rr = row_ring(smem_rows, t, L, W, S, rows);
  const int i_hi = rr.i_hi, c_hi = rr.c_hi;

  if (!walker) {
    copy_rows_ahead(rr, moves + o0 * NW, rows, S, NW,
                    bulk_rows(moves, S, NW));
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
    mbar_wait(rr.full(c), rr.parity(c));  // group c has landed
    // Rows past S (the top group where S % 8 != 0) and rows at or above the
    // lane's seg_qlen are walked on whatever the ring holds and written as
    // unvisited.
    int res[3][kRowLoad];                // mv, h, w_out of the group's rows
#pragma unroll
    for (int k = kRowLoad - 1; k >= 0; --k) {
      const int i = c * kRowLoad + k;
      const uint32_t* r = rr.ring + NW * (i & (kRowRing - 1));
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
    mbar_arrive(rr.empty(c));            // the stage is free again
    const int lo = c * kRowLoad;
    if (live) {
      const int n = min(kRowLoad, i_hi - lo);
#pragma unroll
      for (int a = 0; a < 3; ++a) rows_store(out[a], res[a], lo, n, vout);
    }
    if (lo > 0 && !__any_sync(kFull, live && alive && rows > 0)) {
      // Every lane of the warp has broken or never started: the rest is
      // unvisited.
      if (live) rows_unvisited(out[0], out[1], out[2], 0, lo);
      stop_walking(rr, c, t);
      break;
    }
  }
  if (live) w0_out[lane] = w;
}

// ---------------------------------------------------------------- deposit

// One direction's row walk as ops/align.rows_from_moves leaves it: mv, h,
// wo int32 [n, S] (rows ascending), w0 and qoff int32 [n], ok bool [n].
struct DepositDir {
  const int32_t* mv;
  const int32_t* h;
  const int32_t* wo;
  const int32_t* w0;
  const int32_t* qoff;
  const uint8_t* ok;
};

// One row of the row walk in registers, with the query char it consumes.
struct DepositRow {
  int mv, h, wo, vb;
};

// Words of each accumulator in a warp's share of shared memory: LP chars
// placed up to 3 words in, rounded up to whole 16-byte words.
__host__ __device__ inline int deposit_stride(int LP) {
  return (LP + 3 + 3) & ~3;
}

// An int32 sum that wraps as the reference's int32 tensors wrap.
__device__ __forceinline__ int add_wrap(const int a, const int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__global__ void __launch_bounds__(32 * kDepositWarps, 4)
walk_deposit_kernel(const DepositDir right, const DepositDir left,
                    const uint8_t* __restrict__ q,
                    const int32_t* __restrict__ qseed,
                    int8_t* __restrict__ val0, int32_t* __restrict__ ipack,
                    int32_t* __restrict__ icnt, int32_t* __restrict__ lead,
                    int32_t* __restrict__ bnd_pack,
                    int32_t* __restrict__ bnd_cnt, int32_t* __restrict__ j_end,
                    int n_r, int N, int B, int S, int W, int L_s) {
  extern __shared__ uint4 smem_dep[];
  const int half = W / 2;
  const int LP = S + half - 1;           // output chars of a lane
  const int P = deposit_stride(LP);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lane >= N) return;                 // the whole warp: no block barrier
  const bool is_left = lane >= n_r;
  const DepositDir d = is_left ? left : right;
  const int n = is_left ? lane - n_r : lane;   // the direction's lane
  const int b = n % B;                   // its pair
  const size_t row0 = (size_t)n * S;
  const size_t out0 = (size_t)lane * LP;
  const bool ok = d.ok[n] != 0;
  // char c of the lane sits at word sh + c of its accumulators, so that a
  // 16-byte word of output chars is one in shared memory too
  const int sh = (int)(out0 & 3);
  int32_t* acc = reinterpret_cast<int32_t*>(smem_dep) + (size_t)warp * 3 * P;
  int32_t* key = acc + sh;
  int32_t* ap = acc + P + sh;
  int32_t* ac = acc + 2 * P + sh;

  // The query char of row i: char x of the pair's support row with S
  // zeros on each side, x = start + i (right) or start + S - 1 - i (left:
  // the flipped slice), the start wrapped and clamped as lax.dynamic_slice
  // does it (ops/align.dynamic_slice_start).
  const int qs = qseed[b];
  const int qo = d.qoff[n];
  int start = is_left ? add_wrap(qs, -qo) : add_wrap(add_wrap(S, qs), qo);
  if (start < 0) start += L_s + 2 * S;
  start = min(max(start, 0), L_s + S);
  const int xbase = (is_left ? start + S - 1 : start) - S;
  const int xstep = is_left ? -1 : 1;
  const uint8_t* qrow = q + (size_t)b * L_s;

  // The passes of 32 rows go up the rows on a right lane (a run starts
  // below its rows) and down them on a left lane (a run ends above them).
  const int passes = (S + 31) / 32;
  auto pass_row = [&](const int k) {
    return (is_left ? passes - 1 - k : k) * 32 + t;
  };
  auto load = [&](DepositRow& r, const int k) {
    const int i = pass_row(k);
    if (k < passes && i < S) {
      const size_t x = row0 + i;
      r.mv = d.mv[x];
      r.h = d.h[x];
      r.wo = d.wo[x];
      const int c = xbase + xstep * i;
      r.vb = (unsigned)c < (unsigned)L_s ? qrow[c] : 0;
    }
  };
  // the first two passes' rows are in flight while j_end is found and the
  // accumulators are set; a lane that is not ok deposits nothing
  DepositRow cur{}, nxt{};
  if (ok) {
    load(cur, 0);
    load(nxt, 1);
  }

  // j_end of a left lane: the max of j + h over the visited rows, -1 for
  // a row not visited, ok not applied
  int je = 0;
  if (is_left) {
    je = INT32_MIN;
    for (int i = t; i < S; i += 32) {
      const size_t x = row0 + i;
      const int v = d.mv[x] >= 0
                        ? add_wrap(add_wrap(i + 1 - half, d.wo[x]), d.h[x])
                        : -1;
      je = max(je, v);
    }
    je = __reduce_max_sync(kFull, je);
  }
  for (int u = t; u < 3 * P / 4; u += 32)
    reinterpret_cast<int4*>(acc)[u] =
        u < P / 4 ? make_int4(kKeyNone, kKeyNone, kKeyNone, kKeyNone)
                  : make_int4(0, 0, 0, 0);
  __syncwarp();

  // the side-band runs' largest delta and the OR of their shifted bases
  int sb_cnt = 0;
  uint32_t sb_pack = 0;
  // carried from pass to pass: on a right lane the last run start so far
  // and the top row's VERT and h == 0; on a left lane the first run end
  // so far and the bottom row's VERT
  int carry_idx = is_left ? S : -1;
  bool carry_v = false, carry_h0 = true;
  for (int k = 0; ok && k < passes; ++k) {
    const DepositRow r = cur;
    cur = nxt;
    load(nxt, k + 2);                    // two passes ahead
    const int i = pass_row(k);
    const bool live = i < S;
    const bool isv = live && r.mv == kVert;
    // the row's place in its VERT run (ops/consensus_banded.run_deltas):
    // right, from the run's start (a max-scan of start rows up the warp);
    // left, to the run's end (a min-scan of end rows down the warp)
    int delta;
    if (!is_left) {
      bool below_v = __shfl_up_sync(kFull, isv, 1);
      bool below_h0 = __shfl_up_sync(kFull, r.h == 0, 1);
      if (t == 0) {
        below_v = carry_v;
        below_h0 = carry_h0;
      }
      int s = isv && !(below_v && below_h0) ? i : -1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, s, o);
        if (t >= o) s = max(s, v);
      }
      s = max(s, carry_idx);
      delta = isv ? i - s + 1 : 0;
      carry_idx = __shfl_sync(kFull, s, 31);
      carry_v = __shfl_sync(kFull, isv, 31);
      carry_h0 = __shfl_sync(kFull, r.h == 0, 31);
    } else {
      bool above_v = __shfl_down_sync(kFull, isv, 1);
      if (t == 31) above_v = carry_v;
      int e = isv && !(above_v && r.h == 0) ? i : S;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_down_sync(kFull, e, o);
        if (t + o < 32) e = min(e, v);
      }
      e = min(e, carry_idx);
      delta = isv ? e - i + 1 : 0;
      carry_idx = __shfl_sync(kFull, e, 0);
      carry_v = __shfl_sync(kFull, isv, 0);
    }
    // a VERT run anchored in the neighbouring segment (j == 0 right,
    // j == j_end left) goes to the side arrays, not to the planes
    const int j = add_wrap(i + 1 - half, r.wo);
    const bool side = isv && j == (is_left ? je : 0);
    if (side) {
      sb_cnt = max(sb_cnt, delta);
      if (delta <= kMaxD) sb_pack |= (uint32_t)r.vb << (2 * (delta - 1));
    }
    const int aw = is_left ? add_wrap(r.wo, 1) : r.wo;   // insertion column

    int n_gap = 0, first = 0, gap_key = 0;   // this row's gap marks
    if (live) {
      const int off = i - half;          // char of band column w: off + w
      if ((r.mv == 0 || r.mv == 1) && r.wo >= 0 && r.wo < W && off + r.wo >= 0)
        // the reference's astype(int8) of vbase is the key's low byte
        atomicMin(&key[off + r.wo], ((2 * i + 1) << 8) | (r.vb & 0xff));
      if (r.mv >= 0 && r.wo < W - 1) {
        // columns wo+1 .. wo+h of the band, wo + h wrapping as int32 does
        const int hi = add_wrap(r.wo, r.h);
        int lo = r.wo + 1;
        if (lo < -off) lo = -off;        // chars below 0 are dropped
        if (lo < 0) lo = 0;
        const int top = hi < W - 1 ? hi : W - 1;
        if (top >= lo) {
          n_gap = top - lo + 1;
          first = off + lo;
          gap_key = (2 * i) << 8;
        }
      }
      if (isv && !side && aw >= 0 && aw < W && off + aw >= 0) {
        if (delta <= kMaxD)
          atomicOr(&ap[off + aw], (int)((uint32_t)r.vb << (2 * (delta - 1))));
        atomicMax(&ac[off + aw], delta);
      }
    }
    // the pass's gap cells, numbered across the warp: row t holds cells
    // [incl - n_gap, incl); cell c of it is char first + c - (incl - n_gap)
    int incl = n_gap;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (t >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int base = first - (incl - n_gap);
    for (int c0 = 0; c0 < total; c0 += 32) {
      const int c = c0 + t;
      int row = 0;                       // rows whose cells end at or below c
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, incl, row + step - 1) <= c) row += step;
      }
      row &= 31;                         // 32 only where c >= total
      const int ch = __shfl_sync(kFull, base, row) + c;
      const int gk = __shfl_sync(kFull, gap_key, row);
      if (c < total) atomicMin(&key[ch], gk);
    }
  }
  sb_cnt = __reduce_max_sync(kFull, sb_cnt);
  sb_pack = __reduce_or_sync(kFull, sb_pack);
  if (t == 0) {
    bnd_cnt[lane] = sb_cnt;
    bnd_pack[lane] = (int)sb_pack;
    lead[lane] = max(add_wrap(d.w0[n], -half), 0);
    if (is_left) j_end[n] = je;
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

// The bytes of columns [lo, maxc) of a tape word whose first column is lo,
// one at a time: the part of the top word that is the lane's where the
// word reaches into the next lane's tape.
__device__ __noinline__ void store_top_bytes(uint8_t* out, const int lo,
                                             const int maxc,
                                             const uint32_t word) {
  for (int u = max(lo, 0); u < maxc; ++u)
    out[u] = (uint8_t)(word >> (8 * (u - lo)));
}

// One lane's tape, written backwards from column maxc - 1.  The bytes go
// into a 64-bit register, the newest (lowest column) at its low end; an
// emission of k <= 4 bytes completes at most one word of the tape, which is
// then stored whole, byte by byte only where it reaches into a neighbouring
// lane's tape (the top word where MAXC % 4 != 0; the bottom word is written
// by finish()).
struct Tape {
  uint8_t* out;     // column 0 of the lane's tape
  int maxc;
  int col;          // the next column to write
  int sh0;          // the byte of its word that column 0 is
  uint64_t pack;    // the bytes written last: column col + 1 at bits 0-7

  __device__ __forceinline__ void init(uint8_t* o, const int m) {
    out = o;
    maxc = m;
    col = m - 1;
    sh0 = (int)(reinterpret_cast<uintptr_t>(o) & 3);
    pack = 0;
  }
  // k (1..4) bytes at columns col .. col - k + 1: `bytes` holds them with
  // the one of the lowest column at bits 0-7
  __device__ __forceinline__ void emit(const uint32_t bytes, const int k) {
    pack = (pack << (8 * k)) | bytes;
    const int hi = col;
    col -= k;
    const int zc = hi - ((sh0 + hi) & 3);  // the word's first column
    // the word, once its bytes are all in (zc > col)
    const uint32_t word = (uint32_t)(pack >> (8 * ((zc - col - 1) & 7)));
    if (zc > col && zc + 3 < maxc)
      *reinterpret_cast<uint32_t*>(out + zc) = word;
    else if (zc > col)
      store_top_bytes(out, zc, maxc, word);
  }
  // n copies of v
  __device__ __forceinline__ void run(const uint32_t v, int n) {
    const uint32_t word = (v & 0xffu) * 0x01010101u;
    for (; n >= 4; n -= 4) emit(word, 4);
    if (n > 0) emit(word >> (8 * (4 - n)), n);
  }
  // once col is -1: the bytes of a word that starts before column 0
  __device__ __forceinline__ void finish() {
    for (int u = 0; u < 3 - ((sh0 + 3) & 3) && u < maxc; ++u)
      out[u] = (uint8_t)(pack >> (8 * u));
  }
};

// The slow step's search, in device memory: the highest non-horizontal cell
// at or below (row i, column w) as the reference reads a lane's moves (one
// flat vector, word (i-1)*W/16 + floor(w/16) clipped to [0, last], cell
// w mod 16; a run goes on down the flat cells).  Returns the horizontal
// cells passed before it and sets *code, or returns `budget` where none lies
// within `budget` cells (word 0 read again and again below the lane, all
// horizontal, has none at all).
__device__ __forceinline__ int search_flat(const uint32_t* __restrict__ lm,
                                           const int last, const int NW,
                                           const int i, const int w,
                                           const int budget, int* code) {
  // int32 as the reference computes it
  int idx = (int)((uint32_t)(i - 1) * (uint32_t)NW + (uint32_t)(w >> 4));
  int b = w & 15;                       // the cell in the word: floor mod
  int h = 0;
  while (h < budget) {
    const int ci = idx < 0 ? 0 : (idx > last ? last : idx);
    const uint32_t x = __ldg(lm + ci);
    const uint32_t y = not_horizontal(x) & (0xffffffffu >> (30 - 2 * b));
    if (y) {
      const int bit = 31 - __clz(y);
      *code = (int)((x >> bit) & 3u);
      return h + b - (bit >> 1);
    }
    h += b + 1;
    if (idx < 0 && b == 15) return budget;
    b = 15;
    --idx;
  }
  return budget;
}

// The exit of any row step, as a lane takes it where the common step does
// not (a run that leaves the row at column 0, a column outside [0, W), a
// row above S, which has no ring row: rw null, a run of more than 3, the
// cut, the tape's top word) and for the rest of that group: (h, code), h
// horizontal codes then the exit's code, or h = rem where none lies within
// `rem`.
__device__ __noinline__ int2 slow_exit(const uint32_t* rw,
                                       const uint32_t* __restrict__ lm,
                                       const int last, const int NW,
                                       const int W, const int i, const int w,
                                       const int rem) {
  int code = 0;
  if (rw != nullptr && (unsigned)w < (unsigned)W) {
    // down the row's words in shared memory
    const int j = w >> 4;
    uint32_t y = not_horizontal(rw[j]) & (0xffffffffu >> (30 - 2 * (w & 15)));
    int q = j;
    for (int u = j - 1; !y && u >= 0; --u) {
      y = not_horizontal(rw[u]);
      q = u;
    }
    if (y) {
      const int bit = 31 - __clz(y);
      return make_int2(w - (16 * q + (bit >> 1)), (int)((rw[q] >> bit) & 3u));
    }
    // the run leaves the row at column 0: on down the rows below
    const int h = search_flat(lm, last, NW, i, -1, rem - (w + 1), &code);
    return make_int2(w + 1 + h, code);
  }
  const int h = search_flat(lm, last, NW, i, w, rem, &code);
  return make_int2(h, code);
}

// A row step in full, at row i and column w, `rw` its ring row (null above
// S): h horizontal codes, then the exit, or horizontal codes to the cut
// where they do not fit.  Inlined, so the walk's state stays in registers.
__device__ __forceinline__ void full_step(const uint32_t* rw,
                                          const uint32_t* __restrict__ lm,
                                          const int last, const int NW,
                                          const int W, int& i, int& w, int& s,
                                          bool& walking, Tape& tape) {
  const int rem = tape.maxc - s;
  const int2 e = slow_exit(rw, lm, last, NW, W, i, w, rem);
  if (e.x >= rem) {
    tape.run(kHoriz, rem);
    s = tape.maxc;
    walking = false;
    return;
  }
  tape.run(kHoriz, e.x);
  tape.emit((uint32_t)e.y, 1);
  s += e.x + 1;
  --i;
  w += (e.y == kVert ? 1 : 0) - e.x;
  walking = s < tape.maxc;
}

__global__ void __launch_bounds__(64)
walk_cols_kernel(const uint32_t* __restrict__ moves,
                 const int32_t* __restrict__ seg_qlen,
                 const int32_t* __restrict__ w_end, uint8_t* __restrict__ ops,
                 int32_t* __restrict__ n_cols, int N, int S, int W, int L,
                 int maxc) {
  extern __shared__ uint4 smem_cols[];
  const int t = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;  // warp 0 walks, warp 1 copies
  const int lane = blockIdx.x * L + t;   // of both warps' thread t
  const bool live = t < L && lane < N;
  const int NW = W >> 4;                 // words a row
  const uint32_t* lm = moves + (size_t)(live ? lane : 0) * S * NW;
  // rows 0 .. min(seg_qlen, S) - 1 are the lane's, walked descending
  const int rows = live ? min(max(seg_qlen[lane], 0), S) : 0;
  const RowRing rr = row_ring(smem_cols, t, L, W, S, rows);

  if (!walker) {
    copy_rows_ahead(rr, lm, rows, S, NW, bulk_rows(moves, S, NW));
    return;
  }

  const int last = S * NW - 1;
  int i = live ? seg_qlen[lane] : -1;    // the row (1-based) and the column
  int w = live ? w_end[lane] : 0;
  int s = 0;                             // tape columns emitted
  bool walking = live && i >= 0;         // i = 0: row 0's deletions only
  Tape tape;
  tape.init(ops + (size_t)(live ? lane : 0) * maxc, maxc);
  // rows above S (seg_qlen > S) read the lane's last word, clipped
  while (walking && i > S)
    full_step(nullptr, lm, last, NW, W, i, w, s, walking, tape);
  for (int c = rr.c_hi; c >= 0; --c) {
    mbar_wait(rr.full(c), rr.parity(c));  // group c has landed
    // The common step, branch-free: the exit in w's own word j up to w,
    // else in word j - 1, both read at once, a run of at most 3 horizontal
    // codes, room for it on the tape, and no word of it shared with the
    // next lane's tape.  A lane whose step is another stops at that row
    // for the rest of the group (its i no longer matches).
#pragma unroll
    for (int k = kRowLoad - 1; k >= 0; --k) {
      const int r = c * kRowLoad + k;     // the step of the lanes at i = r + 1
      const uint32_t* rw = rr.ring + NW * (r & (kRowRing - 1));
      const int wc = (unsigned)w < (unsigned)W ? w : 0;
      const int j = wc >> 4;
      const uint32_t x1 = rw[j];
      const uint32_t x0 = rw[j > 0 ? j - 1 : 0];
      const uint32_t y1 =
          not_horizontal(x1) & (0xffffffffu >> (30 - 2 * (wc & 15)));
      const uint32_t y0 = j > 0 ? not_horizontal(x0) : 0u;
      const uint32_t x = y1 ? x1 : x0;
      const uint32_t y = y1 ? y1 : y0;
      const int q = y1 ? j : j - 1;
      const int bit = (31 - __clz(y)) & 31;
      const int col = 16 * q + (bit >> 1);
      const int code = (int)((x >> bit) & 3u);
      const int h = (w - col) & 3;        // the run, where it is at most 3
      const int n = h + 1;                // tape columns of the step
      // its h horizontal codes above the exit's code, and the word they
      // complete, if any
      const uint64_t pk =
          (tape.pack << (8 * n)) |
          ((uint32_t)code | ((0x030303u >> (8 * (3 - h))) << 8));
      const int lo = tape.col - n;        // the tape's next column after it
      const int zc = tape.col - ((tape.sh0 + tape.col) & 3);
      const bool whole = zc > lo;
      const bool common = walking && i == r + 1 && w == wc && y != 0u &&
                          w - col <= 3 && n <= maxc - s &&
                          !(whole && zc + 3 >= maxc);
      if (common && whole)
        *reinterpret_cast<uint32_t*>(tape.out + zc) =
            (uint32_t)(pk >> (8 * ((zc - lo - 1) & 7)));
      tape.pack = common ? pk : tape.pack;
      tape.col = common ? lo : tape.col;
      walking = common ? s + n < maxc : walking;
      s = common ? s + n : s;
      i = common ? i - 1 : i;
      w = common ? col + (code == kVert ? 1 : 0) : w;
    }
    // the lanes that stopped in the group: the rest of their rows of it,
    // each step as it comes
    const int lo_row = c * kRowLoad;
    if (__any_sync(kFull, walking && i - 1 >= lo_row)) {
      while (walking && i - 1 >= lo_row)
        full_step(rr.ring + NW * ((i - 1) & (kRowRing - 1)), lm, last, NW, W,
                  i, w, s, walking, tape);
    }
    mbar_arrive(rr.empty(c));            // the stage is free again
    if (c > 0 && !__any_sync(kFull, walking && i > 0)) {
      stop_walking(rr, c, t);            // every lane of the warp is past
      break;                             // its rows
    }
  }
  if (live) {
    // row 0: the leading target deletions while w - W/2 > 0, to the cut
    if (walking && i == 0) {
      const int n = min(max(w - W / 2, 0), maxc - s);
      tape.run(kHoriz, n);
      s += n;
    }
    tape.run(0xffu, tape.col + 1);       // -1 before the tape
    tape.finish();
    n_cols[lane] = s;
  }
}

}  // namespace

// moves int32 [N, S, W/16], seg_qlen and w_end int32 [N]; outputs mv, h,
// w_out int32 [N, S] and w0 int32 [N], uninitialised: every element is
// written.  All device pointers, row-major, contiguous.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue, without a launch, for a W that is not a multiple
// of 16 in [16, 24576] or an S below 1.
extern "C" int mecat_walk_rows(const void* moves, const void* seg_qlen,
                               const void* w_end, void* mv, void* h, void* wo,
                               void* w0, int N, int S, int W, void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || W <= 0 || W % 16 || W > kMaxW)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  const int L = row_lanes(W);
  const size_t smem = row_smem(W, L);
  const cudaError_t err = allow_smem(walk_rows_kernel, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  walk_rows_kernel<<<blocks_for(N, L), 64, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(moves),
      static_cast<const int32_t*>(seg_qlen),
      static_cast<const int32_t*>(w_end), static_cast<int32_t*>(mv),
      static_cast<int32_t*>(h), static_cast<int32_t*>(wo),
      static_cast<int32_t*>(w0), N, S, W, L);
  return (int)cudaGetLastError();
}

// Both directions' row walks, each as ops/align.rows_from_moves leaves it:
// mv, h, wo int32 [n, S] (rows ascending), w0, qoff int32 [n] and ok bool
// [n], n = n_r right lanes and n_l left ones, lane n of a direction on pair
// n % B; q uint8 [B, L_s] the pairs' support windows and qseed int32 [B].
// Outputs, uninitialised (every element is written), the right lanes
// first: val0 int8, ipack and icnt int32 [n_r + n_l, S + W/2 - 1]
// (ipack and icnt 16-byte aligned, val0 4-byte aligned, as torch.empty
// gives them), lead, bnd_pack and bnd_cnt int32 [n_r + n_l], and the left
// lanes' j_end int32 [n_l].  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue, without a launch, for an odd or non-positive
// W, an S below 1, B below 1, L_s below 0, misaligned outputs, or an S
// whose accumulators do not fit the block's shared memory for one lane.
extern "C" int mecat_walk_deposit_rows(
    const void* mv_r, const void* h_r, const void* wo_r, const void* w0_r,
    const void* qoff_r, const void* ok_r, const void* mv_l, const void* h_l,
    const void* wo_l, const void* w0_l, const void* qoff_l, const void* ok_l,
    const void* q, const void* qseed, void* val0, void* ipack, void* icnt,
    void* lead, void* bnd_pack, void* bnd_cnt, void* j_end, int n_r, int n_l,
    int B, int S, int W, int L_s, void* stream) {
  if (n_r < 0 || n_l < 0) return (int)cudaErrorInvalidValue;
  const int N = n_r + n_l;
  if (N == 0) return 0;
  if (B <= 0 || S <= 0 || W <= 0 || W % 2 || L_s < 0)
    return (int)cudaErrorInvalidValue;
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
  auto dir = [](const void* mv, const void* h, const void* wo, const void* w0,
                const void* qoff, const void* ok) {
    return DepositDir{static_cast<const int32_t*>(mv),
                      static_cast<const int32_t*>(h),
                      static_cast<const int32_t*>(wo),
                      static_cast<const int32_t*>(w0),
                      static_cast<const int32_t*>(qoff),
                      static_cast<const uint8_t*>(ok)};
  };
  walk_deposit_kernel<<<blocks_for(N, warps), 32 * warps, warps * per_lane,
                        static_cast<cudaStream_t>(stream)>>>(
      dir(mv_r, h_r, wo_r, w0_r, qoff_r, ok_r),
      dir(mv_l, h_l, wo_l, w0_l, qoff_l, ok_l),
      static_cast<const uint8_t*>(q), static_cast<const int32_t*>(qseed),
      static_cast<int8_t*>(val0), static_cast<int32_t*>(ipack),
      static_cast<int32_t*>(icnt), static_cast<int32_t*>(lead),
      static_cast<int32_t*>(bnd_pack), static_cast<int32_t*>(bnd_cnt),
      static_cast<int32_t*>(j_end), n_r, N, B, S, W, L_s);
  return (int)cudaGetLastError();
}

// moves int32 [N, S, W/16], seg_qlen and w_end int32 [N]; outputs ops int8
// [N, max_cols] (the tape, right-aligned, -1 before it) and n_cols int32
// [N], uninitialised: every element is written.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue, without a launch, for a W that
// is not a multiple of 16 in [16, 24576], an S below 1 or max_cols below 1.
extern "C" int mecat_walk_cols(const void* moves, const void* seg_qlen,
                               const void* w_end, void* ops, void* n_cols,
                               int N, int S, int W, int max_cols,
                               void* stream) {
  if (N <= 0) return 0;
  if (S <= 0 || W <= 0 || W % 16 || W > kMaxW || max_cols <= 0)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  const int L = row_lanes(W);
  const size_t smem = row_smem(W, L);
  const cudaError_t err = allow_smem(walk_cols_kernel, smem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  walk_cols_kernel<<<blocks_for(N, L), 64, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(moves),
      static_cast<const int32_t*>(seg_qlen),
      static_cast<const int32_t*>(w_end), static_cast<uint8_t*>(ops),
      static_cast<int32_t*>(n_cols), N, S, W, L, max_cols);
  return (int)cudaGetLastError();
}
