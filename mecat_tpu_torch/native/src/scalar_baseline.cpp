// Scalar single-thread overlapper in the style of the reference C++: the
// 1-core denominator of the bench (python -m mecat_tpu_torch.bench
// --scalar) and an algorithm-level differential oracle for the index, the
// candidates and the extensions.
//
// Copy of mecat_tpu/native/src/scalar_baseline.cpp; the code is unchanged.
// It mirrors the STYLE of the 2017 reference implementation (chained-hash
// k-mer lookup probed one read at a time, scalar per-(target, diagonal)
// block scoring, scalar banded gap-aligner extension): plain loops, one
// thread, no SIMD intrinsics, no batching.  The ALGORITHM SEMANTICS are
// the framework's own (ops/ddf.py scan -> merge, ops/align.py segmented
// banded wavefront with packed (distance, indel) values), replicated
// exactly so candidate sets and alignments are bit-comparable with the
// torch paths (tests/test_torch_scalar_baseline.py).  At 12-14% read error
// a W=128 band costs about the same cells per pair as the reference's
// O(ND) diff loop (D ~ 0.25*span).
//
// Build: g++ -O2 at first use via mecat_tpu_torch/native/scalar.py
// (ctypes, plain C ABI).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

// ---- constants mirrored from constants.py + ops/align.py ---------------
constexpr int32_t IND_K = 4096;       // packed val = dist * IND_K + indels
constexpr int32_t K1 = IND_K + 1;     // one indel step in packed units
constexpr int32_t VINF = 1 << 30;     // masked-cell value
constexpr int32_t INF = 1 << 20;      // distance infinity
constexpr int32_t DIAG_SHIFT = 1 << 20;
constexpr int32_t NEG_SCORE = -(1 << 26);

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// ---- k-mer CSR index (direct-address, stride-1, like index/kmer_index) --
struct ScalarIndex {
  int k = 0;
  std::vector<int64_t> offsets;   // [4^k + 1]
  std::vector<int32_t> pos_rid;   // occurrence read id, sorted by code
  std::vector<int32_t> pos_loc;   // offset within the read
  // volume tables
  const uint8_t* codes = nullptr;
  std::vector<int64_t> starts;
  std::vector<int32_t> lengths;
  int64_t n_reads = 0;
  int64_t n_valid = 0;
  int64_t n_distinct = 0;
};

struct Hit {                       // one probe hit of a sampled query k-mer
  int32_t rid, dbin, qpos, loc;
  bool operator<(const Hit& o) const {
    if (rid != o.rid) return rid < o.rid;
    if (dbin != o.dbin) return dbin < o.dbin;
    if (qpos != o.qpos) return qpos < o.qpos;
    return loc < o.loc;
  }
};

struct Cand {                      // one DDF candidate (per strand)
  int32_t target, score, qseed, tseed;
};

// ---- banded segmented extension (ops/align.py semantics, scalar) --------
struct ExtState {                  // one direction's accumulators
  int32_t q_adv = 0, t_adv = 0, dist = 0, matches = 0, alen = 0, n_segs = 0;
};

struct DpBest { int32_t r, w, j, d, ind; };

// One S x W banded DP segment + local-best endpoint (banded_dp_segment +
// pick_end_local).  q/t are sentinel-padded far enough that all reads
// below stay in bounds; tmax = usable target window length.
static DpBest dp_segment_best(const uint8_t* q_seg, const uint8_t* t_seg,
                              int32_t tmax, int32_t seg_q, int S, int W,
                              int penalty, std::vector<int32_t>& prev,
                              std::vector<int32_t>& cur) {
  const int half = W / 2;
  // row 0: j0 = w - half; val = j0 * K1 where 0 <= j0 <= tmax
  for (int w = 0; w < W; ++w) {
    int32_t j0 = w - half;
    prev[w] = (j0 >= 0 && j0 <= tmax) ? j0 * K1 : VINF;
  }
  // best over all rows (pick_end_local): score = r + j - 2*penalty*dist,
  // first (r, w) in flat order wins ties (argmax semantics)
  int32_t best_score = NEG_SCORE;
  DpBest best{0, 0, 0, 0, 0};
  for (int w = 0; w < W; ++w) {
    int32_t j = w - half;
    if (j < 0 || j > tmax || prev[w] >= VINF) continue;
    int32_t sc = 0 + j - 2 * penalty * (prev[w] / IND_K);
    if (sc > best_score) {
      best_score = sc;
      best = {0, w, j, prev[w] / IND_K, prev[w] % IND_K};
    }
  }
  for (int i = 1; i <= S; ++i) {
    const uint8_t qc = q_seg[i - 1];
    // cand = min(diag, vert) masked; then horizontal closure (running min)
    int32_t run = VINF;  // min_{u<=w} cand[u] - u*K1, carried as +w*K1 form
    for (int w = 0; w < W; ++w) {
      const int32_t j = i - half + w;
      const uint8_t td = t_seg[i - 1 + w];   // t_seg pre-shifted by -half
      int32_t diag = prev[w] + (qc == td ? 0 : IND_K);
      int32_t vert = (w + 1 < W ? prev[w + 1] : VINF) + K1;
      int32_t cand = diag < vert ? diag : vert;
      bool valid = (j >= 0) && (j <= tmax);
      if (!valid) cand = VINF;
      // closure: cur[w] = min(cand[w], cur[w-1] + K1)
      run = (run >= VINF ? VINF : run + K1);
      if (cand < run) run = cand;
      int32_t v = run < VINF ? run : VINF;
      cur[w] = valid ? v : VINF;
      if (valid && cur[w] < VINF && i <= seg_q) {
        int32_t sc = i + j - 2 * penalty * (cur[w] / IND_K);
        if (sc > best_score) {
          best_score = sc;
          best = {i, w, j, cur[w] / IND_K, cur[w] % IND_K};
        }
      }
    }
    std::swap(prev, cur);
  }
  return best;
}

// Segmented extension in one direction (_extend_direction_impl).  q/t are
// the full padded arrays for this direction; q0/t0 starting offsets.
static ExtState extend_direction(const uint8_t* q, const uint8_t* t,
                                 int32_t q0, int32_t t0, int32_t qlen,
                                 int32_t tlen, int S, int W, int max_segs,
                                 int penalty, float min_seg_identity,
                                 std::vector<int32_t>& prev,
                                 std::vector<int32_t>& cur) {
  const int half = W / 2;
  ExtState st;
  bool active = qlen > 0 && tlen > 0;
  for (int seg = 0; seg < max_segs && active; ++seg) {
    st.n_segs += 1;
    int32_t seg_q = std::min(std::max(qlen - st.q_adv, 0), S);
    int32_t rem_t = std::min(std::max(tlen - st.t_adv, 0), S + half);
    // t_seg pointer pre-shifted so t_seg[i-1+w] = window[(i-half+w) - 1]:
    // window char x lives at t[t0 + toff + x]; index (i-1+w) maps to
    // x = i - 1 + w - half.
    const uint8_t* q_seg = q + q0 + st.q_adv;
    const uint8_t* t_seg = t + t0 + st.t_adv - half;
    DpBest b = dp_segment_best(q_seg, t_seg, rem_t, seg_q, S, W, penalty,
                               prev, cur);
    int32_t m_seg = std::max((b.r + b.j + b.ind) / 2 - b.d, 0);
    int32_t a_seg = m_seg + b.d;
    float ident = float(m_seg) / float(std::max(a_seg, 1));
    bool ok = active && (b.r + b.j > 0) && (b.d < INF) &&
              (ident >= min_seg_identity || a_seg < 32);
    int32_t q2 = ok ? st.q_adv + b.r : st.q_adv;
    int32_t t2 = ok ? st.t_adv + b.j : st.t_adv;
    if (ok) {
      st.dist += b.d;
      st.matches += m_seg;
      st.alen += a_seg;
    }
    int slack = std::max(1, S / 4);
    active = ok && (b.r >= seg_q - slack) && (b.r >= 1) && (q2 < qlen) &&
             (t2 < tlen);
    st.q_adv = q2;
    st.t_adv = t2;
  }
  return st;
}

struct PairResult {
  int32_t qbeg, qend, tbeg, tend, dist, matches, alen, n_segs;
  float identity;
};

// Both-direction extension of a seed (_pair_batch_impl, counts path).
// q: oriented query (qlen bases); t: forward target (tlen bases).
static PairResult extend_pair(const uint8_t* qb, int32_t qlen,
                              const uint8_t* tb, int32_t tlen,
                              int32_t qseed, int32_t tseed, int S, int W,
                              int max_segs, int penalty,
                              float min_seg_identity,
                              std::vector<uint8_t>& qbuf,
                              std::vector<uint8_t>& tbuf,
                              std::vector<uint8_t>& qrbuf,
                              std::vector<uint8_t>& trbuf,
                              std::vector<int32_t>& prev,
                              std::vector<int32_t>& cur) {
  const int half = W / 2;
  // forward buffers: [bases | sentinel pad]; reverse buffers: flipped.
  // The left direction reads t_seg at offset (t0 + toff - half) which can
  // be negative relative to the flipped origin, so reverse targets get a
  // half-band sentinel PREFIX too (the JAX path's t_rev is index-shifted
  // identically via its tpad construction).
  const size_t qcap = size_t(qlen) + S + 8;
  const size_t tcap = size_t(tlen) + S + W + 2 * half + 8;
  if (qbuf.size() < qcap) qbuf.resize(qcap);
  if (tbuf.size() < tcap) tbuf.resize(tcap);
  if (qrbuf.size() < qcap) qrbuf.resize(qcap);
  if (trbuf.size() < tcap) trbuf.resize(tcap);
  std::memcpy(qbuf.data() + 0, qb, qlen);
  std::memset(qbuf.data() + qlen, 0xFF, qcap - qlen);         // Q_SENTINEL
  std::memset(tbuf.data(), 0xFE, tcap);                       // T_SENTINEL
  std::memcpy(tbuf.data() + half, tb, tlen);
  for (int32_t i = 0; i < qlen; ++i) qrbuf[i] = qb[qlen - 1 - i];
  std::memset(qrbuf.data() + qlen, 0xFF, qcap - qlen);
  std::memset(trbuf.data(), 0xFE, tcap);
  for (int32_t i = 0; i < tlen; ++i) trbuf[half + i] = tb[tlen - 1 - i];

  // right: from (qseed, tseed) forward.  t pointer passed with the +half
  // prefix folded in so extend_direction's (t0 - half) lands at index 0.
  ExtState right = extend_direction(qbuf.data(), tbuf.data() + half, qseed,
                                    tseed, qlen - qseed, tlen - tseed, S, W,
                                    max_segs, penalty, min_seg_identity,
                                    prev, cur);
  // left: on reversed arrays, from (qlen - qseed, tlen - tseed)
  ExtState left = extend_direction(qrbuf.data(), trbuf.data() + half,
                                   qlen - qseed, tlen - tseed, qseed, tseed,
                                   S, W, max_segs, penalty, min_seg_identity,
                                   prev, cur);
  PairResult r;
  r.qbeg = qseed - left.q_adv;
  r.qend = qseed + right.q_adv;
  r.tbeg = tseed - left.t_adv;
  r.tend = tseed + right.t_adv;
  r.dist = left.dist + right.dist;
  r.matches = left.matches + right.matches;
  r.alen = left.alen + right.alen;
  r.n_segs = left.n_segs + right.n_segs;
  r.identity = 100.0f * float(r.matches) / float(std::max(r.alen, 1));
  return r;
}

// ---- DDF scan of one oriented read (ops/ddf.py semantics, scalar) -------
static void scan_read(const ScalarIndex& ix, const uint8_t* bases,
                      int32_t qlen, int32_t self_id, int stride, int max_occ,
                      int64_t cutoff, int diag_bin, int n_cand,
                      std::vector<Hit>& hits, std::vector<Cand>& out) {
  hits.clear();
  out.clear();
  const int k = ix.k;
  const int64_t mask_hi = (int64_t(1) << (2 * k));
  // sampled k-mer probe
  int64_t code = 0;
  for (int32_t qpos = 0; qpos + k <= qlen; qpos += stride) {
    code = 0;
    for (int j = 0; j < k; ++j) code = (code << 2) | bases[qpos + j];
    if (code < 0 || code >= mask_hi) continue;   // defensive
    int64_t off = ix.offsets[code];
    int64_t cnt = ix.offsets[code + 1] - off;
    if (cnt > cutoff) continue;                  // high-frequency drop
    int64_t take = cnt < max_occ ? cnt : max_occ;
    for (int64_t j = 0; j < take; ++j) {
      int32_t rid = ix.pos_rid[off + j];
      if (rid == self_id) continue;
      int32_t loc = ix.pos_loc[off + j];
      hits.push_back({rid, (qpos - loc + DIAG_SHIFT) / diag_bin, qpos, loc});
    }
  }
  if (hits.empty()) return;
  std::sort(hits.begin(), hits.end());
  // run-length scores over equal (rid, dbin); top-n by (score desc, run
  // start asc) — lax.top_k tie semantics
  struct Run { int32_t start, len; };
  std::vector<Run> runs;
  int32_t rs = 0;
  for (size_t i = 1; i <= hits.size(); ++i) {
    if (i == hits.size() || hits[i].rid != hits[rs].rid ||
        hits[i].dbin != hits[rs].dbin) {
      runs.push_back({rs, int32_t(i) - rs});
      rs = int32_t(i);
    }
  }
  std::stable_sort(runs.begin(), runs.end(),
                   [](const Run& a, const Run& b) { return a.len > b.len; });
  int n = std::min<int>(n_cand, int(runs.size()));
  for (int i = 0; i < n; ++i) {
    const Run& r = runs[i];
    const Hit& seed = hits[r.start + r.len / 2];
    out.push_back({hits[r.start].rid, r.len, seed.qpos, seed.loc});
  }
}

struct Engine {
  ScalarIndex ix;
  // reusable scratch
  std::vector<Hit> hits;
  std::vector<Cand> cand_f, cand_r, merged;
  std::vector<uint8_t> rc, qbuf, tbuf, qrbuf, trbuf;
  std::vector<int32_t> prev, cur;
};

}  // namespace

extern "C" {

// Build the scalar index over a volume (counting sort, stride-1 positions,
// (code, position)-sorted occurrences — array-equal to index/kmer_index).
void* sb_build(const uint8_t* codes, const int64_t* starts,
               const int32_t* lengths, int64_t n_reads, int k) {
  Engine* e = new Engine();
  ScalarIndex& ix = e->ix;
  ix.k = k;
  ix.codes = codes;
  ix.starts.assign(starts, starts + n_reads);
  ix.lengths.assign(lengths, lengths + n_reads);
  ix.n_reads = n_reads;
  const int64_t n_slots = int64_t(1) << (2 * k);
  std::vector<int64_t> counts(n_slots, 0);
  // pass 1: count valid k-mers (those fitting inside their read)
  for (int64_t r = 0; r < n_reads; ++r) {
    const uint8_t* b = codes + starts[r];
    const int32_t len = lengths[r];
    if (len < k) continue;
    int64_t code = 0;
    const int64_t mask = (int64_t(1) << (2 * k)) - 1;
    for (int32_t i = 0; i < k - 1; ++i) code = (code << 2) | b[i];
    for (int32_t p = 0; p + k <= len; ++p) {
      code = ((code << 2) | b[p + k - 1]) & mask;
      counts[code] += 1;
    }
  }
  ix.offsets.resize(n_slots + 1);
  ix.offsets[0] = 0;
  int64_t distinct = 0;
  for (int64_t s = 0; s < n_slots; ++s) {
    ix.offsets[s + 1] = ix.offsets[s] + counts[s];
    distinct += counts[s] > 0;
  }
  const int64_t total = ix.offsets[n_slots];
  ix.n_valid = total;
  ix.n_distinct = distinct;
  ix.pos_rid.resize(total);
  ix.pos_loc.resize(total);
  // pass 2: place occurrences (reads in order => position-sorted per code)
  std::vector<int64_t> cursor(ix.offsets.begin(), ix.offsets.end() - 1);
  for (int64_t r = 0; r < n_reads; ++r) {
    const uint8_t* b = codes + starts[r];
    const int32_t len = lengths[r];
    if (len < k) continue;
    int64_t code = 0;
    const int64_t mask = (int64_t(1) << (2 * k)) - 1;
    for (int32_t i = 0; i < k - 1; ++i) code = (code << 2) | b[i];
    for (int32_t p = 0; p + k <= len; ++p) {
      code = ((code << 2) | b[p + k - 1]) & mask;
      int64_t at = cursor[code]++;
      ix.pos_rid[at] = int32_t(r);
      ix.pos_loc[at] = p;
    }
  }
  return e;
}

void sb_free(void* h) { delete static_cast<Engine*>(h); }
int64_t sb_n_valid(void* h) { return static_cast<Engine*>(h)->ix.n_valid; }
int64_t sb_n_distinct(void* h) {
  return static_cast<Engine*>(h)->ix.n_distinct;
}

// Scan one oriented read; returns number of candidates written (top order).
int32_t sb_scan_read(void* h, const uint8_t* bases, int32_t qlen,
                     int32_t self_id, int32_t stride, int32_t max_occ,
                     int64_t cutoff, int32_t diag_bin, int32_t n_cand,
                     int32_t* out_target, int32_t* out_score,
                     int32_t* out_qseed, int32_t* out_tseed) {
  Engine* e = static_cast<Engine*>(h);
  scan_read(e->ix, bases, qlen, self_id, stride, max_occ, cutoff, diag_bin,
            n_cand, e->hits, e->cand_f);
  for (size_t i = 0; i < e->cand_f.size(); ++i) {
    out_target[i] = e->cand_f[i].target;
    out_score[i] = e->cand_f[i].score;
    out_qseed[i] = e->cand_f[i].qseed;
    out_tseed[i] = e->cand_f[i].tseed;
  }
  return int32_t(e->cand_f.size());
}

// Extend one (query, target, seed) pair; out = [qbeg, qend, tbeg, tend,
// dist, matches, alen, n_segs], identity returned separately.
void sb_extend_pair(void* h, const uint8_t* q, int32_t qlen,
                    const uint8_t* t, int32_t tlen, int32_t qseed,
                    int32_t tseed, int32_t S, int32_t W, int32_t max_segs,
                    int32_t penalty, float min_seg_identity, int32_t* out,
                    float* identity) {
  Engine* e = static_cast<Engine*>(h);
  if (e->prev.size() < size_t(W)) { e->prev.resize(W); e->cur.resize(W); }
  PairResult r =
      extend_pair(q, qlen, t, tlen, qseed, tseed, S, W, max_segs, penalty,
                  min_seg_identity, e->qbuf, e->tbuf, e->qrbuf, e->trbuf,
                  e->prev, e->cur);
  out[0] = r.qbeg; out[1] = r.qend; out[2] = r.tbeg; out[3] = r.tend;
  out[4] = r.dist; out[5] = r.matches; out[6] = r.alen; out[7] = r.n_segs;
  *identity = r.identity;
}

// The TIMED single-thread all-vs-all driver: for every query read in
// [q_lo, q_hi), scan both strands, merge per-read top-n across strands
// (score desc, strand 0 before strand 1 on ties — the host-merge
// tie-break), then extend every kept candidate and apply the M4 filters.
// Returns counts + wall-time breakdown; this is the measured
// reference-style socket-core rate (BASELINE.md).
// strands: 2 = scan fwd + revcomp and merge (the production pw semantics);
// 1 = forward only (apples-to-apples with bench.py's single-orientation
// fused step).  out_counts[4] = pre-dedup pass count (the chip bench's
// `valid` tally does not dedup (target, strand) repeats).
void sb_overlap_range(void* h, int64_t q_lo, int64_t q_hi, int32_t task,
                      int32_t stride, int32_t max_occ, int64_t cutoff,
                      int32_t diag_bin, int32_t n_cand,
                      int32_t min_block_score, int32_t S, int32_t W,
                      int32_t penalty, float min_seg_identity,
                      float min_identity, int32_t min_align_size,
                      int32_t strands,
                      int64_t* out_counts, double* out_secs) {
  Engine* e = static_cast<Engine*>(h);
  ScalarIndex& ix = e->ix;
  int64_t n_candidates = 0, n_extended = 0, n_overlaps = 0, n_segs = 0;
  int64_t n_pass = 0;
  double t_scan = 0.0, t_extend = 0.0;
  if (e->prev.size() < size_t(W)) { e->prev.resize(W); e->cur.resize(W); }
  for (int64_t qr = q_lo; qr < q_hi; ++qr) {
    const uint8_t* fwd = ix.codes + ix.starts[qr];
    const int32_t qlen = ix.lengths[qr];
    if (e->rc.size() < size_t(qlen)) e->rc.resize(qlen);
    for (int32_t i = 0; i < qlen; ++i) e->rc[i] = 3 - fwd[qlen - 1 - i];
    double t0 = now_s();
    scan_read(ix, fwd, qlen, int32_t(qr), stride, max_occ, cutoff, diag_bin,
              n_cand, e->hits, e->cand_f);
    std::swap(e->cand_f, e->cand_r);   // keep strand-0 list in cand_r? no:
    // (cand_f holds the last scan; scan fwd first into cand_f, move it)
    std::vector<Cand> strand0 = e->cand_r;  // copy (small)
    e->cand_f.clear();
    if (strands >= 2)
      scan_read(ix, e->rc.data(), qlen, int32_t(qr), stride, max_occ,
                cutoff, diag_bin, n_cand, e->hits, e->cand_f);
    // merge: stable by (score desc); strand0 entries first on ties
    e->merged.clear();
    size_t i0 = 0, i1 = 0;
    std::vector<int32_t> mstrand;
    while ((i0 < strand0.size() || i1 < e->cand_f.size()) &&
           int(e->merged.size()) < n_cand) {
      bool take0;
      if (i0 >= strand0.size()) take0 = false;
      else if (i1 >= e->cand_f.size()) take0 = true;
      else take0 = strand0[i0].score >= e->cand_f[i1].score;
      const Cand& c = take0 ? strand0[i0++] : e->cand_f[i1++];
      if (c.score < min_block_score) { continue; }
      e->merged.push_back(c);
      mstrand.push_back(take0 ? 0 : 1);
    }
    t_scan += now_s() - t0;
    n_candidates += int64_t(e->merged.size());
    if (task == 0) continue;
    t0 = now_s();
    // extension + filters + best-span dedup per (target, strand)
    struct BestOvl { int32_t span = -1; };
    // (targets are few per read; linear key scan is fine at n_cand<=100)
    std::vector<int32_t> keys;           // target*2 + strand
    std::vector<int32_t> spans;
    for (size_t ci = 0; ci < e->merged.size(); ++ci) {
      const Cand& c = e->merged[ci];
      const int32_t strand = mstrand[ci];
      const uint8_t* qb = strand == 0 ? fwd : e->rc.data();
      const uint8_t* tb = ix.codes + ix.starts[c.target];
      const int32_t tlen = ix.lengths[c.target];
      int32_t tseed = std::min(std::max(c.tseed, 0),
                               std::max(tlen - 1, 0));
      int32_t lmax = std::max(qlen, tlen);
      int32_t max_segs = (lmax + (S - S / 4) - 1) / (S - S / 4) + 2;
      PairResult r = extend_pair(qb, qlen, tb, tlen,
                                 std::max(c.qseed, 0), tseed, S, W,
                                 max_segs, penalty, min_seg_identity,
                                 e->qbuf, e->tbuf, e->qrbuf, e->trbuf,
                                 e->prev, e->cur);
      n_extended += 1;
      n_segs += r.n_segs;
      int32_t qspan = r.qend - r.qbeg, tspan = r.tend - r.tbeg;
      if (r.identity >= min_identity &&
          std::min(qspan, tspan) >= min_align_size) {
        n_pass += 1;
        int32_t key = c.target * 2 + strand;
        int32_t span = qspan + tspan;
        bool found = false;
        for (size_t kk = 0; kk < keys.size(); ++kk)
          if (keys[kk] == key) {
            found = true;
            if (span > spans[kk]) spans[kk] = span;
            break;
          }
        if (!found) {
          keys.push_back(key);
          spans.push_back(span);
          n_overlaps += 1;
        }
      }
    }
    t_extend += now_s() - t0;
  }
  out_counts[0] = n_candidates;
  out_counts[1] = n_extended;
  out_counts[2] = n_overlaps;
  out_counts[3] = n_segs;
  out_counts[4] = n_pass;
  out_secs[0] = t_scan;
  out_secs[1] = t_extend;
}

}  // extern "C"
