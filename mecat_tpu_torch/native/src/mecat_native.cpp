// Native host-side data layer of mecat_tpu_torch.
//
// Copy of mecat_tpu/native/src/mecat_native.cpp; the code is unchanged.  The
// reference keeps its data layer (PackedDB / FastaReader / M4 writers) in
// C++ because host parsing and serialisation must not starve the compute;
// the same holds for feeding the GPU, so the hot host paths live in this
// translation unit:
//
//   * FASTA/FASTQ -> flat uint8 code arrays (+ starts/lengths/names)
//   * 2-bit pack / unpack (4 bases per byte, LSB-first)
//   * padded [B, L] batch gather
//   * batched M4 / candidate line formatting and table parsing, the
//     streaming partition writer of the correction input
//   * FASTA serialisation, banded edit statistics
//
// Exposed as a plain C ABI consumed via ctypes (native/api.py).  All
// functions are single-threaded and reentrant.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint8_t kInvalid = 0;  // must match constants.INVALID_BASE_CODE

struct CodeLut {
  uint8_t m[256];
  CodeLut() {
    memset(m, kInvalid, sizeof(m));
    m[(unsigned)'A'] = 0; m[(unsigned)'a'] = 0;
    m[(unsigned)'C'] = 1; m[(unsigned)'c'] = 1;
    m[(unsigned)'G'] = 2; m[(unsigned)'g'] = 2;
    m[(unsigned)'T'] = 3; m[(unsigned)'t'] = 3;
  }
};
const CodeLut kLut;
const char kDecode[4] = {'A', 'C', 'G', 'T'};

thread_local std::string g_error;

// The file's bytes; empty with g_error set on failure.  An empty file is
// told from a failed read by g_error, so it is cleared first: an error of
// an earlier call must not stick to this one.
std::vector<char> read_whole_file(const char* path) {
  std::vector<char> buf;
  g_error.clear();
  FILE* f = fopen(path, "rb");
  if (!f) { g_error = std::string("cannot open ") + path; return buf; }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 0) sz = 0;
  buf.resize((size_t)sz);
  if (sz && fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    g_error = std::string("short read on ") + path;
    buf.clear();
  }
  fclose(f);
  return buf;
}

}  // namespace

extern "C" {

const char* mt_error() { return g_error.c_str(); }

// ---------------------------------------------------------------------------
// FASTA / FASTQ parsing
// ---------------------------------------------------------------------------

struct MtDB {
  std::vector<uint8_t> codes;
  std::vector<int64_t> starts;
  std::vector<int32_t> lengths;
  std::string names;  // '\n'-joined read names (first token of header)
};

// Parse FASTA or FASTQ (auto-detected on first non-space byte).  Returns
// NULL on error (see mt_error()).  Gzip inputs are decompressed by the
// Python caller before reaching here.
MtDB* mt_parse_path(const char* path) {
  std::vector<char> buf = read_whole_file(path);
  if (buf.empty() && !g_error.empty()) return nullptr;

  MtDB* db = new MtDB();
  db->codes.reserve(buf.size());
  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end && (*p == '\n' || *p == '\r' || *p == ' ')) ++p;
  if (p >= end) return db;  // empty file -> empty db

  auto push_name = [&](const char* s, const char* e) {
    // first whitespace-delimited token of the header
    const char* t = s;
    while (t < e && *t != ' ' && *t != '\t' && *t != '\r') ++t;
    if (!db->names.empty()) db->names.push_back('\n');
    db->names.append(s, t);
  };

  if (*p == '>') {  // FASTA
    int64_t cur_start = -1;
    while (p < end) {
      if (*p == '>') {
        if (cur_start >= 0) {
          db->starts.push_back(cur_start);
          db->lengths.push_back((int32_t)(db->codes.size() - cur_start));
        }
        ++p;
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl) nl = end;
        push_name(p, nl);
        cur_start = (int64_t)db->codes.size();
        p = nl + 1;
      } else {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl) nl = end;
        for (const char* q = p; q < nl; ++q) {
          unsigned char c = (unsigned char)*q;
          if (c > ' ') db->codes.push_back(kLut.m[c]);
        }
        p = nl + 1;
      }
    }
    if (cur_start >= 0) {
      db->starts.push_back(cur_start);
      db->lengths.push_back((int32_t)(db->codes.size() - cur_start));
    }
  } else if (*p == '@') {  // FASTQ: 4-line records
    while (p < end) {
      while (p < end && (*p == '\n' || *p == '\r')) ++p;
      if (p >= end) break;
      if (*p != '@') {
        g_error = "bad FASTQ header line";
        delete db;
        return nullptr;
      }
      ++p;
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) nl = end;
      push_name(p, nl);
      p = nl + 1;
      int64_t cur_start = (int64_t)db->codes.size();
      nl = p < end ? (const char*)memchr(p, '\n', end - p) : end;
      if (!nl) nl = end;
      for (const char* q = p; q < nl; ++q) {
        unsigned char c = (unsigned char)*q;
        if (c > ' ') db->codes.push_back(kLut.m[c]);
      }
      db->starts.push_back(cur_start);
      db->lengths.push_back((int32_t)(db->codes.size() - cur_start));
      p = nl + 1;
      // '+' line
      nl = p < end ? (const char*)memchr(p, '\n', end - p) : end;
      if (!nl) nl = end;
      p = nl + 1;
      // quality line (must exist)
      if (p > end) { g_error = "truncated FASTQ record"; delete db; return nullptr; }
      nl = p < end ? (const char*)memchr(p, '\n', end - p) : end;
      if (!nl) nl = end;
      p = nl + 1;
    }
  } else {
    g_error = "not FASTA/FASTQ";
    delete db;
    return nullptr;
  }
  return db;
}

int64_t mt_db_n_reads(MtDB* db) { return (int64_t)db->lengths.size(); }
int64_t mt_db_total_bases(MtDB* db) { return (int64_t)db->codes.size(); }
int64_t mt_db_names_size(MtDB* db) { return (int64_t)db->names.size(); }

void mt_db_fill(MtDB* db, uint8_t* codes, int64_t* starts, int32_t* lengths,
                char* names) {
  if (codes && !db->codes.empty())
    memcpy(codes, db->codes.data(), db->codes.size());
  if (starts && !db->starts.empty())
    memcpy(starts, db->starts.data(), db->starts.size() * sizeof(int64_t));
  if (lengths && !db->lengths.empty())
    memcpy(lengths, db->lengths.data(), db->lengths.size() * sizeof(int32_t));
  if (names && !db->names.empty())
    memcpy(names, db->names.data(), db->names.size());
}

void mt_db_free(MtDB* db) { delete db; }

// ---------------------------------------------------------------------------
// 2-bit packing (A=0 C=1 G=2 T=3, base i in bits 2*(i%4) of byte i/4)
// ---------------------------------------------------------------------------

void mt_pack_2bit(const uint8_t* codes, int64_t n, uint8_t* out) {
  int64_t nb = n / 4;
  for (int64_t i = 0; i < nb; ++i) {
    const uint8_t* c = codes + 4 * i;
    out[i] = (uint8_t)((c[0] & 3) | ((c[1] & 3) << 2) | ((c[2] & 3) << 4) |
                       ((c[3] & 3) << 6));
  }
  if (n % 4) {
    uint8_t b = 0;
    for (int64_t j = nb * 4; j < n; ++j) b |= (codes[j] & 3) << (2 * (j % 4));
    out[nb] = b;
  }
}

void mt_unpack_2bit(const uint8_t* packed, int64_t n_bases, uint8_t* out) {
  int64_t nb = n_bases / 4;
  for (int64_t i = 0; i < nb; ++i) {
    uint8_t b = packed[i];
    out[4 * i + 0] = b & 3;
    out[4 * i + 1] = (b >> 2) & 3;
    out[4 * i + 2] = (b >> 4) & 3;
    out[4 * i + 3] = (b >> 6) & 3;
  }
  for (int64_t j = nb * 4; j < n_bases; ++j)
    out[j] = (packed[j / 4] >> (2 * (j % 4))) & 3;
}

// ---------------------------------------------------------------------------
// Padded batch gather: reads -> dense [B, L] uint8 (pad 0), lengths clipped
// ---------------------------------------------------------------------------

void mt_padded_batch(const uint8_t* codes, const int64_t* starts,
                     const int32_t* lengths, const int64_t* ids, int64_t n_ids,
                     int64_t L, uint8_t* out, int32_t* out_lens) {
  memset(out, 0, (size_t)(n_ids * L));
  for (int64_t r = 0; r < n_ids; ++r) {
    int64_t id = ids[r];
    int64_t len = lengths[id];
    if (len > L) len = L;
    memcpy(out + r * L, codes + starts[id], (size_t)len);
    out_lens[r] = (int32_t)len;
  }
}

// ---------------------------------------------------------------------------
// Batched M4 / candidate formatting
// ---------------------------------------------------------------------------

namespace {
char* put_i64(char* o, int64_t v) {
  if (v < 0) { *o++ = '-'; v = -v; }
  char tmp[20];
  int n = 0;
  do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
  while (n) *o++ = tmp[--n];
  return o;
}
// %.2f — must agree byte-for-byte with Python's f"{v:.2f}" (both round the
// exact binary double to nearest, ties to even), so delegate to snprintf.
char* put_f2(char* o, double v) {
  return o + snprintf(o, 32, "%.2f", v);
}
}  // namespace

// M4: qid sid identity score qstrand qstart qend qsize sstrand sstart send ssize
// Returns bytes written, or -(bytes needed) if cap is too small.
int64_t mt_format_m4(int64_t n, const int32_t* qid, const int32_t* sid,
                     const double* identity, const int32_t* score,
                     const int32_t* qstrand, const int32_t* qstart,
                     const int32_t* qend, const int32_t* qsize,
                     const int32_t* sstrand, const int32_t* sstart,
                     const int32_t* send, const int32_t* ssize, char* out,
                     int64_t cap) {
  // worst case ~ 12 fields * 12 chars
  if (cap < n * 160) return -(n * 160);
  char* o = out;
  for (int64_t i = 0; i < n; ++i) {
    o = put_i64(o, qid[i]); *o++ = '\t';
    o = put_i64(o, sid[i]); *o++ = '\t';
    o = put_f2(o, identity[i]); *o++ = '\t';
    o = put_i64(o, score[i]); *o++ = '\t';
    o = put_i64(o, qstrand[i]); *o++ = '\t';
    o = put_i64(o, qstart[i]); *o++ = '\t';
    o = put_i64(o, qend[i]); *o++ = '\t';
    o = put_i64(o, qsize[i]); *o++ = '\t';
    o = put_i64(o, sstrand[i]); *o++ = '\t';
    o = put_i64(o, sstart[i]); *o++ = '\t';
    o = put_i64(o, send[i]); *o++ = '\t';
    o = put_i64(o, ssize[i]); *o++ = '\n';
  }
  return o - out;
}

// Candidates: qid sid score qdir qext qsize sdir sext ssize
int64_t mt_format_candidates(int64_t n, const int32_t* qid, const int32_t* sid,
                             const int32_t* score, const int32_t* qdir,
                             const int32_t* qext, const int32_t* qsize,
                             const int32_t* sdir, const int32_t* sext,
                             const int32_t* ssize, char* out, int64_t cap) {
  if (cap < n * 120) return -(n * 120);
  char* o = out;
  for (int64_t i = 0; i < n; ++i) {
    o = put_i64(o, qid[i]); *o++ = '\t';
    o = put_i64(o, sid[i]); *o++ = '\t';
    o = put_i64(o, score[i]); *o++ = '\t';
    o = put_i64(o, qdir[i]); *o++ = '\t';
    o = put_i64(o, qext[i]); *o++ = '\t';
    o = put_i64(o, qsize[i]); *o++ = '\t';
    o = put_i64(o, sdir[i]); *o++ = '\t';
    o = put_i64(o, sext[i]); *o++ = '\t';
    o = put_i64(o, ssize[i]); *o++ = '\n';
  }
  return o - out;
}

// ---------------------------------------------------------------------------
// Batched whitespace-separated numeric table parsing (M4 / candidate files).
// Parses up to `ncols` leading numeric columns per non-empty line into
// float64; extra columns are ignored.  Returns a handle.
// ---------------------------------------------------------------------------

struct MtTable {
  std::vector<double> vals;  // row-major [n_rows, ncols]
  int64_t n_rows = 0;
  int32_t ncols = 0;
};

MtTable* mt_parse_table(const char* path, int32_t ncols) {
  std::vector<char> buf = read_whole_file(path);
  if (buf.empty() && !g_error.empty()) return nullptr;
  // strtod needs a terminator: a file ending in a numeric token at its very
  // last byte must not let strtod scan past the allocation.
  buf.push_back('\0');
  MtTable* t = new MtTable();
  t->ncols = ncols;
  const char* p = buf.data();
  const char* end = p + buf.size() - 1;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    // skip blank lines
    const char* q = p;
    while (q < nl && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q < nl) {
      int32_t col = 0;
      while (q < nl && col < ncols) {
        char* next = nullptr;
        double v = strtod(q, &next);
        if (next == q) break;
        t->vals.push_back(v);
        ++col;
        q = next;
        while (q < nl && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      }
      if (col != ncols) {
        g_error = "short row in table " + std::string(path);
        delete t;
        return nullptr;
      }
      t->n_rows++;
    }
    p = nl + 1;
  }
  return t;
}

int64_t mt_table_rows(MtTable* t) { return t->n_rows; }
void mt_table_fill(MtTable* t, double* out) {
  if (!t->vals.empty())
    memcpy(out, t->vals.data(), t->vals.size() * sizeof(double));
}
void mt_table_free(MtTable* t) { delete t; }

// ---------------------------------------------------------------------------
// Streaming table partitioning by template-id range (the reference
// overlaps_partition / partition_candidates role, SURVEY.md §3.2: spill
// support rows to per-template-range files so consensus never holds the
// whole input in RAM).  Rows are parsed ONE BUFFERED LINE at a time — peak
// memory is the IO buffers, never the file — and appended, with the
// original row index as an extra trailing column (the consensus tie-break
// needs global insertion order), to out_dir/part_<pid>.bin for every
// DISTINCT partition its two template sides (columns 0 and 1, 1-based read
// ids) fall in.  Binary format: raw native-endian float64 rows of
// (ncols + 1) values.  Returns rows processed, or -1 on error (mt_error()).
// ---------------------------------------------------------------------------

int64_t mt_partition_table(const char* path, int32_t ncols,
                           int64_t part_size, int64_t n_parts,
                           const char* out_dir) {
  if (part_size <= 0 || n_parts <= 0 || ncols < 2) {
    g_error = "bad partition parameters";
    return -1;
  }
  FILE* in = fopen(path, "rb");
  if (!in) { g_error = std::string("cannot open ") + path; return -1; }
  std::vector<FILE*> outs((size_t)n_parts, nullptr);
  auto out_for = [&](int64_t pid) -> FILE* {
    if (pid < 0) pid = 0;
    if (pid >= n_parts) pid = n_parts - 1;
    if (!outs[(size_t)pid]) {
      char buf[4096];
      snprintf(buf, sizeof(buf), "%s/part_%lld.bin", out_dir,
               (long long)pid);
      outs[(size_t)pid] = fopen(buf, "wb");
    }
    return outs[(size_t)pid];
  };
  auto close_all = [&]() {
    for (FILE*& f : outs) if (f) { fclose(f); f = nullptr; }
    fclose(in);
  };

  char line[65536];
  std::vector<double> row((size_t)ncols + 1);
  int64_t n_rows = 0;
  while (fgets(line, sizeof(line), in)) {
    const char* q = line;
    while (*q == ' ' || *q == '\t' || *q == '\r') ++q;
    if (*q == '\n' || *q == '\0') continue;  // blank line
    int32_t col = 0;
    while (col < ncols) {
      char* next = nullptr;
      double v = strtod(q, &next);
      if (next == q) break;
      row[(size_t)col++] = v;
      q = next;
    }
    if (col != ncols) {
      g_error = "short row in table " + std::string(path);
      close_all();
      return -1;
    }
    row[(size_t)ncols] = (double)n_rows;
    int64_t pid_q = ((int64_t)row[0] - 1) / part_size;
    int64_t pid_s = ((int64_t)row[1] - 1) / part_size;
    FILE* f1 = out_for(pid_s);  // side 1: template = sid (column 1)
    if (!f1 || fwrite(row.data(), sizeof(double), row.size(), f1)
                   != row.size()) {
      g_error = "partition write failed";
      close_all();
      return -1;
    }
    if (pid_q != pid_s) {       // side 2: template = qid (column 0)
      FILE* f2 = out_for(pid_q);
      if (!f2 || fwrite(row.data(), sizeof(double), row.size(), f2)
                     != row.size()) {
        g_error = "partition write failed";
        close_all();
        return -1;
      }
    }
    ++n_rows;
  }
  close_all();
  return n_rows;
}

// ---------------------------------------------------------------------------
// FASTA serialisation: codes + per-record ranges -> wrapped FASTA text blob.
// Returns bytes written or -(bytes needed).
// ---------------------------------------------------------------------------

int64_t mt_format_fasta(const uint8_t* codes, const int64_t* starts,
                        const int32_t* lengths, int64_t n,
                        const char* names_blob, int32_t width, char* out,
                        int64_t cap) {
  if (width <= 0) width = 1;  // the loop below would never advance on <= 0
  int64_t need = 0;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += lengths[i];
  need = total + (width > 0 ? total / width + n : n) + (int64_t)strlen(names_blob) + 4 * n + 16;
  if (cap < need) return -need;
  char* o = out;
  const char* name = names_blob;
  for (int64_t i = 0; i < n; ++i) {
    const char* name_end = strchr(name, '\n');
    size_t name_len = name_end ? (size_t)(name_end - name) : strlen(name);
    *o++ = '>';
    memcpy(o, name, name_len);
    o += name_len;
    *o++ = '\n';
    const uint8_t* c = codes + starts[i];
    int32_t len = lengths[i];
    for (int32_t j = 0; j < len; j += width) {
      int32_t m = len - j < width ? len - j : width;
      for (int32_t x = 0; x < m; ++x) o[x] = kDecode[c[j + x] & 3];
      o += m;
      *o++ = '\n';
    }
    name = name_end ? name_end + 1 : name + name_len;
  }
  return o - out;
}

// ---------------------------------------------------------------------------
// Banded edit distance with path decomposition (accuracy QC: the reference
// validates corrected-read quality against a truth alignment — SURVEY.md §4
// property-test mandate).  Transforms a -> b with unit costs.  mode 0 =
// global; mode 1 = infix (global in a, FREE leading/trailing gaps in b —
// the corrected-read-vs-truth-window shape, where coverage trims clip the
// read ends).  out_stats receives {subs, ins, dels, edge} where ins = extra
// bases in a, dels = bases of b missing from a (inside the aligned span
// only, for mode 1), and edge = 1 when the optimal path touched the band
// boundary (caller should widen the band and retry).  Returns the distance,
// or -1 on bad arguments.  Memory: (la+1) x bandwidth move bytes (~15 MB
// for 10 kb reads, band 512).
// ---------------------------------------------------------------------------

int64_t mt_edit_stats(const uint8_t* a, int64_t la, const uint8_t* b,
                      int64_t lb, int32_t band, int32_t mode,
                      int64_t* out_stats) {
  if (la < 0 || lb < 0 || band < 1 || (mode != 0 && mode != 1)) {
    g_error = "bad edit args";
    return -1;
  }
  // diagonal offsets j - i covered by the band
  const int64_t lo_off = (lb < la ? lb - la : 0) - band;
  const int64_t hi_off = (lb > la ? lb - la : 0) + band;
  const int64_t Wb = hi_off - lo_off + 1;
  const int32_t INF = INT32_MAX / 4;
  std::vector<int32_t> prev((size_t)Wb, INF), cur((size_t)Wb, INF);
  std::vector<uint8_t> moves;
  moves.resize((size_t)(la + 1) * (size_t)Wb);  // 0=diag,1=up(ins),2=left(del)
  auto col0 = [&](int64_t i) { return i + lo_off; };  // j at band slot 0

  for (int64_t j = 0; j <= lb && j - 0 <= hi_off; ++j) {
    prev[(size_t)(j - lo_off)] = mode == 1 ? 0 : (int32_t)j;  // free prefix?
    moves[(size_t)(j - lo_off)] = 2;
  }
  for (int64_t i = 1; i <= la; ++i) {
    uint8_t* mrow = moves.data() + (size_t)i * (size_t)Wb;
    const int64_t jlo = col0(i) < 0 ? 0 : col0(i);
    const int64_t jhi = (i + hi_off) < lb ? (i + hi_off) : lb;
    std::fill(cur.begin(), cur.end(), INF);
    for (int64_t j = jlo; j <= jhi; ++j) {
      const int64_t s = j - col0(i);                  // band slot
      int32_t best;
      uint8_t mv;
      // up: (i-1, j) -> slot s+1 in prev (prev row's col0 is one less)
      int32_t up = (s + 1 < Wb) ? prev[(size_t)(s + 1)] : INF;
      if (up < INF) up += 1;
      if (j == 0) { best = up; mv = 1; }
      else {
        int32_t diag = prev[(size_t)s];               // (i-1, j-1)
        if (diag < INF) diag += (a[i - 1] == b[j - 1] ? 0 : 1);
        int32_t left = (s > 0) ? cur[(size_t)(s - 1)] : INF;
        if (left < INF) left += 1;
        best = diag; mv = 0;
        if (up < best) { best = up; mv = 1; }
        if (left < best) { best = left; mv = 2; }
      }
      cur[(size_t)s] = best;
      mrow[(size_t)s] = mv;
    }
    std::swap(prev, cur);
  }
  // end cell: (la, lb) for global; argmin over the last row for infix
  int64_t end_j = lb;
  if (mode == 1) {
    int32_t bst = INF;
    const int64_t jlo = col0(la) < 0 ? 0 : col0(la);
    const int64_t jhi = (la + hi_off) < lb ? (la + hi_off) : lb;
    for (int64_t j = jlo; j <= jhi; ++j) {
      const int32_t v = prev[(size_t)(j - col0(la))];
      if (v < bst) { bst = v; end_j = j; }
    }
  }
  const int64_t end_s = end_j - col0(la);
  if (end_s < 0 || end_s >= Wb || prev[(size_t)end_s] >= INF) {
    g_error = "band too narrow for alignment";
    return -1;
  }
  const int64_t dist = prev[(size_t)end_s];
  // traceback for the decomposition (mode 1 stops at the free row 0)
  int64_t subs = 0, ins = 0, dels = 0, edge = 0;
  int64_t i = la, j = end_j;
  while (i > 0 || (mode == 0 && j > 0)) {
    const int64_t s = j - col0(i);
    if (s == 0 || s == Wb - 1) edge = 1;
    const uint8_t mv = moves[(size_t)i * (size_t)Wb + (size_t)s];
    if (mv == 0) { if (a[i - 1] != b[j - 1]) ++subs; --i; --j; }
    else if (mv == 1) { ++ins; --i; }
    else { ++dels; --j; }
  }
  out_stats[0] = subs; out_stats[1] = ins; out_stats[2] = dels;
  out_stats[3] = edge;
  return dist;
}

// ASCII -> 2-bit codes (bulk); non-ACGT -> 0 (constants.INVALID_BASE_CODE,
// i.e. 'A' — N bases deliberately collapse to A, matching the Python LUT)
void mt_encode_bases(const uint8_t* ascii, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = kLut.m[ascii[i]];
}

void mt_decode_bases(const uint8_t* codes, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = (uint8_t)kDecode[codes[i] & 3];
}

}  // extern "C"
