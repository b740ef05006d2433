"""Inputs and option sets shared by the port's tests and ``chip_smoke.py``.

``dp_inputs`` makes DP-segment lanes as the kernel takes them,
``pair_inputs`` query/target pairs with seeds for the segmented extension,
``roll_micro_inputs`` lanes for the row-update micro-benchmark family;
``dp_segment_best_wavefront`` evaluates a DP segment in the order of the
Hopper kernel (``csrc/dp_segment.cu``), padded band, move ring
(``move_rows_ring``) and the lanes of several warps past 512 included, and
``walk_rows_words`` / ``deposit_scan_warp`` / ``walk_cols_rows`` the row
walk, the deposit and the row-stepped column walk as ``csrc/cns_walk.cu``
does, and ``global_planes_pairwise`` / ``fold_tags_cells`` the tag fold's
two kernels (``csrc/cns_fold.cu``) on the edge inputs of ``fold_inputs``
(``fold_case`` puts them, or a chunk's, on a device), so the CPU tests can
hold each order against the plain version;
``GOLDEN_J1`` / ``GOLDEN_J0`` are the ``PwOptions`` that produced
``tests/golden/overlaps.m4`` and ``tests/golden/candidates.txt``, and
``GOLDEN_CNS`` the ``CnsOptions`` of ``tests/golden/corrected.fasta``.
``cns_pile`` is the simulated pile of the correction tests with its
candidates (``PILE_PW`` / ``PILE_CNS`` are its options); ``tiled_reads``,
``noisy_tiled_reads``, ``perfect_overlaps`` and ``db_from`` make the tiled
layouts of the assembly tests, and ``polish_case`` a contig of such reads
stitched and ready to polish.  The sharded drivers' cases are copies of the
JAX package's tests: ``dist_reads`` / ``DIST_PW`` (``tests/test_dist.py``),
``sharded_case`` / ``SHARDED_CFG`` (``tests/test_sharded.py``) and
``cns_dist_pile`` / ``CNS_DIST_OPTS`` (``tests/test_cns_dist.py``).

``python -m mecat_tpu_torch.testing --rank R --world N --init-method
file://... --work DIR TASK...`` is one rank of the multi-rank checks: it
joins the process group, runs each task on the cases above and writes what
it found under DIR (see :func:`rank_main`); :func:`run_ranks` starts N of
them and fails when any fails or outlives its timeout.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import constants as C
from .io.fasta import write_fasta
from .io.m4 import M4Record, format_block
from .io.packed_db import PackedDB, revcomp
from .ops.align import IND_K, VINF, _NEG, _unpack_best
from .tools.roll_micro import make_inputs as roll_micro_tool_inputs
from .utils.sim import mutate, random_genome, simulate_reads

GOLDEN_J1 = dict(task=1, kmer_size=9, scan_stride=4, min_align_size=400,
                 num_candidates=12, scan_batch=8, extend_batch=32,
                 align_segment=128, align_band=64, min_block_score=2)
GOLDEN_J0 = dict(task=0, kmer_size=9, scan_stride=4, num_candidates=12,
                 scan_batch=8, min_block_score=2)
#: the CnsOptions that made tests/golden/corrected.fasta from candidates.txt
GOLDEN_CNS = dict(min_align_size=300, min_length=500, extend_batch=32,
                  align_segment=128, align_band=64)
#: the candidate scan and the correction options of :func:`cns_pile`
PILE_PW = dict(kmer_size=9, scan_stride=4, num_candidates=12, scan_batch=8,
               min_block_score=2)
PILE_CNS = GOLDEN_CNS


def cns_pile(work_dir: str, *, device):
    """28 reads of mean 1.8 kb at 10 % error over a 9 kb genome, written to
    ``work_dir``/r.fa, and their ``-j 0`` candidates in ``work_dir``/c.txt
    (made on ``device``).  Returns (db, reads path, candidates path)."""
    from .pipeline.pw import PwOptions, run_pw

    genome = random_genome(9000, seed=51)
    db, _ = simulate_reads(genome, 28, mean_len=1800, min_len=1000,
                           seed=52, error_rate=0.1)
    reads = os.path.join(work_dir, "r.fa")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    cand = os.path.join(work_dir, "c.txt")
    run_pw(reads, cand, os.path.join(work_dir, "w0"),
           PwOptions(task=0, **PILE_PW), db=db, device=device)
    return db, reads, cand


#: the options of tests/test_dist.py
DIST_PW = dict(task=1, kmer_size=9, scan_stride=4, min_align_size=500,
               num_candidates=8, scan_batch=4, extend_batch=64,
               align_segment=128, align_band=64, min_block_score=2)
#: the overlap step's options of tests/test_sharded.py
SHARDED_CFG = dict(k=7, stride=4, max_occ=16, num_candidates=8, diag_bin=128,
                   L_target=2048, S=128, W=64, max_segs=8, min_align_size=300,
                   min_identity=65.0)
#: the correction options of tests/test_cns_dist.py
CNS_DIST_OPTS = dict(min_align_size=300, min_length=500,
                     min_mapping_ratio=0.3, align_segment=128, align_band=64,
                     extend_batch=32, min_identity=65.0)


def dist_reads(work_dir: str):
    """32 reads of mean 2.2 kb at 8 % error over a 15 kb genome (seeds
    31 / 32), written to ``work_dir``/reads.fasta.  Returns (db, path)."""
    genome = random_genome(15000, seed=31)
    db, _ = simulate_reads(genome, 32, mean_len=2200, min_len=1200,
                           seed=32, error_rate=0.08)
    reads = os.path.join(work_dir, "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    return db, reads


def sharded_case():
    """16 reads of mean 1.5 kb over a 12 kb genome (seeds 61 / 62), padded
    to 2048: returns (db, bases u8 [16, 2048], lens i32 [16], self_id)."""
    genome = random_genome(12000, seed=61)
    db, _ = simulate_reads(genome, 16, mean_len=1500, min_len=800, seed=62,
                           error_rate=0.08)
    bases, lens = db.padded_batch(range(16), pad_to=2048)
    return db, bases, lens, np.arange(16, dtype=np.int32)


def cns_dist_pile(work_dir: str, *, device):
    """28 reads of mean 1.8 kb at 10 % error over a 9 kb genome (seeds 61 /
    62), written to ``work_dir``/reads.fasta, and their ``-j 0`` candidates
    in ``work_dir``/cand.txt (made on ``device``).  Returns (db, reads
    path, candidates path)."""
    from .pipeline.pw import PwOptions, run_pw

    genome = random_genome(9000, seed=61)
    db, _ = simulate_reads(genome, 28, mean_len=1800, min_len=1000,
                           seed=62, error_rate=0.1)
    reads = os.path.join(work_dir, "reads.fasta")
    write_fasta(reads, [(db.name(i), db.read(i)) for i in range(db.n_reads)])
    cand = os.path.join(work_dir, "cand.txt")
    run_pw(reads, cand, os.path.join(work_dir, "wrk"),
           PwOptions(task=0, **PILE_PW), db=db, device=device)
    return db, reads, cand


def tiled_reads(genome, n, read_len, step, flip_every=0):
    """Reads tiling the genome with a fixed overlap; read i is reverse
    complemented where ``flip_every`` and i % flip_every == 1.  Returns
    (reads, orients)."""
    reads, orients = [], []
    for i in range(n):
        r = genome[i * step:i * step + read_len]
        o = 1 if (flip_every and i % flip_every == 1) else 0
        reads.append(revcomp(r) if o else r)
        orients.append(o)
    return reads, orients


def noisy_tiled_reads(genome, n, read_len, step, seed, rate=0.05):
    """Forward tiled reads with ``rate`` substitutions each."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        r = np.array(genome[i * step:i * step + read_len])
        err = rng.random(len(r)) < rate
        r[err] = (r[err] + rng.integers(1, 4, err.sum())) % 4
        reads.append(r)
    return reads


def db_from(reads) -> PackedDB:
    """A PackedDB of the given code arrays, named r0, r1, ..."""
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    starts = np.zeros(len(reads), dtype=np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    return PackedDB(np.concatenate(reads), starts, lens,
                    [f"r{i}" for i in range(len(reads))])


def m4_record(q, s, qspan, sspan, qlen, slen, strand=0, ident=99.0,
              score=100) -> M4Record:
    """An M4 record of 0-based read ids q, s."""
    return M4Record(qid=q + 1, sid=s + 1, identity=ident, score=score,
                    qstrand=0, qstart=qspan[0], qend=qspan[1], qsize=qlen,
                    sstrand=strand, sstart=sspan[0], send=sspan[1],
                    ssize=slen)


def perfect_overlaps(reads, orients, read_len, step):
    """Exact M4 records of a tiled layout (adjacent pairs only)."""
    ov = read_len - step
    out = []
    for i in range(len(reads) - 1):
        o = orients[i] ^ orients[i + 1]
        # read i's right part on read i + 1's left part, in forward
        # coordinates of each read
        qs = (step, read_len) if not orients[i] else (0, ov)
        ss = (0, ov) if not orients[i + 1] else (step, read_len)
        out.append(m4_record(i, i + 1, qs, ss, read_len, read_len, strand=o))
    return out


def polish_case(work_dir: str, genome_len: int, n: int, seed: int):
    """A contig to polish: ``n`` noisy 1.2 kb reads every 800 bases of a
    random genome (seed, seed + 1), their perfect overlaps, the one unitig
    and its stitched backbone.  Returns (db, tig, backbone)."""
    from .assembly.ctgcns import stitch_backbone
    from .assembly.ovstore import OverlapStore
    from .assembly.unitig import build_unitigs

    read_len, step = 1200, 800
    genome = random_genome(genome_len, seed=seed)
    reads = noisy_tiled_reads(genome, n, read_len, step, seed + 1)
    db = db_from(reads)
    m4p = os.path.join(work_dir, f"polish_{seed}.m4")
    with open(m4p, "w") as fh:
        fh.write(format_block(perfect_overlaps(reads, [0] * n, read_len,
                                               step)))
    tig = build_unitigs(OverlapStore.from_m4(m4p, n), end_slack=60).unitigs[0]
    return db, tig, stitch_backbone(db, tig)


def dp_inputs(S: int, W: int, n: int, seed: int):
    """Mutated query/target segment pairs (4/4/4 % sub/ins/del) as the
    kernel takes them, with edge lanes: tmax=0 and seg_q=0 (one valid
    cell), tmax=-1 or seg_q=-1 (no valid cell), and inactive lanes.

    Returns numpy (q u8 [n,S], tpad u8 [n,S+W], tmax i32 [n],
    seg_q i32 [n], active bool [n]).
    """
    rng = np.random.default_rng(seed)
    half = W // 2
    q = np.full((n, S), 255, np.uint8)
    tpad = np.full((n, S + W), 254, np.uint8)
    seg_q = np.zeros(n, np.int32)
    tmax = np.zeros(n, np.int32)
    for b in range(n):
        m = int(rng.integers(40, S + 1))
        src = rng.integers(0, 4, m, dtype=np.uint8)
        dst = mutate(src, rng, 0.04, 0.04, 0.04)[:S + half]
        q[b, :m] = src
        tpad[b, half:half + len(dst)] = dst
        seg_q[b] = m
        tmax[b] = len(dst)
    tmax[7::97] = 0
    seg_q[7::97] = 0
    tmax[11::89] = -1
    seg_q[13::83] = -1
    active = np.ones(n, bool)
    active[5::61] = False
    return q, tpad, tmax, seg_q, active


def dp_inputs_full(S: int, W: int, n: int, seed: int):
    """Full-length lanes, the shape the segment loops launch mid-read: an
    S-base query, its 4/4/4 % mutation as the target (``seg_q = S``, tmax up
    to S + W/2).  Returns numpy (q, tpad, tmax, seg_q) as
    :func:`dp_inputs`; the caller chooses the active lanes."""
    rng = np.random.default_rng(seed)
    half = W // 2
    q = rng.integers(0, 4, (n, S), dtype=np.uint8)
    tpad = np.full((n, S + W), 254, np.uint8)
    tmax = np.zeros(n, np.int32)
    for b in range(n):
        ext = np.concatenate([q[b], rng.integers(0, 4, W, dtype=np.uint8)])
        dst = mutate(ext, rng, 0.04, 0.04, 0.04)[:S + half]
        tpad[b, half:half + len(dst)] = dst
        tmax[b] = len(dst)
    return q, tpad, tmax, np.full(n, S, np.int32)


def walk_inputs(S: int, W: int, n: int, seed: int):
    """Random move words for the row and column walks: every 2-bit code,
    negative words (the top slot), a third of the words all horizontal so
    that walks run sideways and some break, and edge lanes: the first 16
    take every pair of seg_qlen in {-1, 0, S, S + 3} and w_end in {-1, 0,
    W - 1, W}; the rest start inside the band.

    Returns numpy (moves int32 [n, S, W/16], seg_qlen, w_end int32 [n]).
    """
    rng = np.random.default_rng(seed)
    moves = rng.integers(-(1 << 31), 1 << 31, (n, S, W // 16)).astype(
        np.int32)
    moves[rng.random(moves.shape) < 0.3] = -1         # 16 horizontal moves
    seg_qlen = rng.integers(1, S + 1, n).astype(np.int32)
    w_end = rng.integers(0, W, n).astype(np.int32)
    edges = [(q, w) for q in (-1, 0, S, S + 3) for w in (-1, 0, W - 1, W)]
    for k, (q, w) in enumerate(edges[:n]):
        seg_qlen[k], w_end[k] = q, w
    return moves, seg_qlen, w_end


def deposit_inputs(S: int, W: int, n: int, seed: int, walk=None):
    """Row arrays for the deposit scan.  From a row walk ``walk`` = (mv, h,
    wo) numpy int32 [n, S] when given, as ``direction_rowinfo`` builds
    them: the anchor at wo (right) or wo + 1 (left, so W after a move out
    of the last column), deltas 0-20, keep_ins on most vertical rows.  Else
    random: mv in [-1, 3], wo and aw in [-2, W + 1] (aw = W on every fifth
    row), h up to W + 3 (so wo + h passes W), deltas 0-20, keep_ins false on
    half the rows.  vbase lies in [0, 16), so vbase << 2(d-1) wraps in
    int32.

    Returns numpy (wo, aw, h, mv, vbase, delta int32 [n, S], keep_ins bool
    [n, S]).
    """
    rng = np.random.default_rng(seed)
    i32 = lambda lo, hi: rng.integers(lo, hi, (n, S)).astype(np.int32)
    if walk is not None:
        mv, h, wo = (np.asarray(a, np.int32) for a in walk)
        aw = wo + rng.integers(0, 2, (n, 1)).astype(np.int32)
        keep_ins = (mv == 2) & (rng.random((n, S)) < 0.8)
    else:
        mv, h = i32(-1, 4), i32(0, W + 4)
        wo, aw = i32(-2, W + 2), i32(-2, W + 2)
        aw[:, ::5] = W
        keep_ins = rng.random((n, S)) < 0.5
    return wo, aw, h, mv, i32(0, 16), i32(0, 21), keep_ins


def pair_inputs(n, L, seed):
    """Query/target pairs around a shared source with seeds near the true
    diagonal, plus edge lanes: seed at 0 and at the end, empty query, a
    seed far off the diagonal, a random (junk) target, and a target longer
    than its row."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, L), np.uint8)
    t = np.zeros((n, L), np.uint8)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    qseed = np.zeros(n, np.int32)
    tseed = np.zeros(n, np.int32)
    for b in range(n):
        m = int(rng.integers(L // 3, L * 3 // 4))
        src = rng.integers(0, 4, m, dtype=np.uint8)
        a = mutate(src, rng, 0.03, 0.06, 0.03)[:L]
        c = mutate(src, rng, 0.03, 0.06, 0.03)[:L]
        if b == 5:
            c = rng.integers(0, 4, len(c), dtype=np.uint8)
        q[b, :len(a)], t[b, :len(c)] = a, c
        qlen[b], tlen[b] = len(a), len(c)
        s = int(rng.integers(0, len(a)))
        qseed[b] = s
        tseed[b] = min(int(s * len(c) / len(a)), len(c) - 1)
    qseed[1], tseed[1] = 0, 0
    qseed[2], tseed[2] = qlen[2], tlen[2] - 1
    qlen[3] = 0
    qseed[3] = 0
    tseed[4] = (tseed[4] + tlen[4] // 2) % tlen[4]
    # a target longer than its row (a truncated target window): the seed
    # lies past the row, so the reverse direction starts at a negative
    # offset, which lax.dynamic_slice wraps before it clamps
    tlen[6] = L + 300
    tseed[6] = L + 100
    return q, t, qlen, tlen, qseed, tseed


def _noisy_copy(src: np.ndarray, rng, rate: float):
    """``src`` with substitutions, deletions and insertions at rate / 3
    each (an inserted random base follows its source base), and the
    position each source base took in the copy (-1 where deleted)."""
    n = len(src)
    r = rng.random(n)
    sub = r < rate / 3
    dele = (r >= rate / 3) & (r < 2 * rate / 3)
    ins = (r >= 2 * rate / 3) & (r < rate)
    bases = np.where(sub, (src + rng.integers(1, 4, n, dtype=np.uint8)) % 4,
                     src).astype(np.uint8)
    counts = 1 - dele.astype(np.int64) + ins
    out = np.repeat(bases, counts)
    ends = np.cumsum(counts)
    out[ends[ins] - 1] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    return out, np.where(dele, -1, ends - counts)


def extend_inputs(n: int, L: int, S: int, seed: int, rate: float = 0.12):
    """Query/target pairs for the segmented extension, rows of L bases: two
    noisy copies (``rate`` split evenly into substitutions, insertions and
    deletions) of a shared source of L/2 to L bases, the seed on a source
    base both copies keep, so on the true diagonal.  The first 13 lanes are
    edge lanes: 0 an empty query, 1 an empty target, 2 seeds at 0, 3 seeds
    at the last bases, 4 the query seed at its end, 5 reads shorter than
    S, 6 a random target, 7 a target that is the query with 45 %
    substitutions (the identity gate stops it), 8 a 20-base query and its
    copy with 8 substitutions, seeds at 0 (identity under 0.65 on fewer
    than 32 columns: the escape of the gate), 9 a target longer than its
    row with the seed past the row (the reverse direction's window start
    wraps), 10 a seed S/4 bases off the diagonal, 11 a target that follows
    the query for half its length and then turns random, 12 a full-length
    pair at 2 % noise seeded at 0 (it runs the most segments).

    Returns numpy (q, t uint8 [n, L], qlen, tlen, qseed, tseed int32 [n]).
    """
    rng = np.random.default_rng(seed)
    q = np.zeros((n, L), np.uint8)
    t = np.zeros((n, L), np.uint8)
    qlen, tlen, qseed, tseed = (np.zeros(n, np.int32) for _ in range(4))

    def put(b, a, c, qs, ts):
        a, c = a[:L], c[:L]
        q[b, :len(a)], t[b, :len(c)] = a, c
        qlen[b], tlen[b] = len(a), len(c)
        qseed[b], tseed[b] = qs, ts

    for b in range(n):
        src = rng.integers(0, 4, int(rng.integers(L // 2, L)), dtype=np.uint8)
        a, pa = _noisy_copy(src, rng, rate)
        c, pc = _noisy_copy(src, rng, rate)
        kept = np.nonzero((pa >= 0) & (pc >= 0) & (pa < L) & (pc < L))[0]
        p = int(rng.choice(kept))
        put(b, a, c, int(pa[p]), int(pc[p]))
    qlen[0] = qseed[0] = 0
    tlen[1] = tseed[1] = 0
    qseed[2] = tseed[2] = 0
    qseed[3], tseed[3] = qlen[3] - 1, tlen[3] - 1
    qseed[4], tseed[4] = qlen[4], tlen[4] - 1
    short = rng.integers(0, 4, S // 3, dtype=np.uint8)
    put(5, _noisy_copy(short, rng, rate)[0], _noisy_copy(short, rng, rate)[0],
        S // 6, S // 6)
    put(6, q[6, :qlen[6]], rng.integers(0, 4, tlen[6], dtype=np.uint8),
        qseed[6], tseed[6])
    a = rng.integers(0, 4, L, dtype=np.uint8)
    c = np.where(rng.random(L) < 0.45,
                 (a + rng.integers(1, 4, L, dtype=np.uint8)) % 4, a)
    put(7, a, c.astype(np.uint8), 0, 0)
    put(8, np.array([int(x) for x in "21033102331312101020"], np.uint8),
        np.array([int(x) for x in "21000212301312211030"], np.uint8), 0, 0)
    tlen[9], tseed[9] = L + 300, L + 100
    tseed[10] = min(tseed[10] + S // 4, tlen[10] - 1)
    a = q[11, :qlen[11]]
    put(11, a, np.concatenate([a[:len(a) // 2], rng.integers(
        0, 4, len(a) - len(a) // 2, dtype=np.uint8)]), 0, 0)
    src = rng.integers(0, 4, L, dtype=np.uint8)
    put(12, _noisy_copy(src, rng, 0.02)[0], _noisy_copy(src, rng, 0.02)[0],
        0, 0)
    return q, t, qlen, tlen, qseed, tseed


def roll_micro_inputs(S: int, W: int, n: int, seed: int):
    """Lanes for the row-update micro-benchmark family.

    The first half are the tool's own lanes (one source, seed 7, as the
    query; its 1/1/1 % mutation, seed 11, as the target; tmax = S + W/2,
    segq = S).  The second half have their own 4/4/4 % mutated sequences
    and varied tmax and segq, with edge lanes: no valid cell (tmax = -1,
    where every ``elem`` key is the wrapped masked one), segq = 0 and a
    2-base target.  Returns numpy (q u8 [n,S], t u8 [n,S+W], tmax i32 [n],
    segq i32 [n]).
    """
    q, t, tmax, segq = roll_micro_tool_inputs(n, S, W)
    rng = np.random.default_rng(seed)
    for b in range(n // 2, n):
        own = rng.integers(0, 4, S + W, dtype=np.uint8)
        dst = mutate(own, rng, 0.04, 0.04, 0.04)[:S + W]
        q[b] = own[:S]
        t[b] = 0
        t[b, :len(dst)] = dst
        tmax[b] = rng.integers(0, S + W // 2 + 1)
        segq[b] = rng.integers(0, S + 1)
    tmax[n // 2 + 1] = -1
    segq[n // 2 + 2] = 0
    tmax[n // 2 + 3] = 2
    return q, t, tmax, segq


#: band cells a warp of a wide lane holds (``csrc/dp_segment.cu``, kSliceW)
SLICE_W = 512
#: the widest band one block holds a lane for (``csrc/dp_segment.cu``,
#: kMaxW: six slices); past it a lane is a thread-block cluster
BLOCK_W = 3072


def cluster_shape(W: int):
    """(m, p) of ``csrc/dp_segment.cu`` for a band of W past 512: the
    blocks of the lane and the warps (slices) of each.  Up to 3072 one block
    of n = ceil(W / 512) warps; past it a cluster of m = ceil(n / 6) blocks
    of p = ceil(n / m) warps, the m p - n slices past the band's last all
    padding."""
    n = -(-W // SLICE_W)
    if W <= BLOCK_W:
        return 1, n
    m = -(-n // 6)
    return m, -(-n // m)


def band_cells(W: int):
    """(C, Wp) of ``csrc/dp_segment.cu`` for a band of W: band cells a
    thread (even) and the band cells the lane holds, Wp >= W: Wp = 32 * C
    up to 512, past it C = 16 and a warp for each 512 cells of the lane's
    m blocks of p warps (:func:`cluster_shape`)."""
    if W > SLICE_W:
        m, p = cluster_shape(W)
        return 16, SLICE_W * m * p
    C = 2 * -(-W // 64)
    return C, 32 * C


def move_rows_ring(codes: np.ndarray, last: int, S: int, W: int):
    """The move words [S, W/16] int32 of one lane as ``csrc/dp_segment.cu``
    assembles them, from the codes [S, W] of its rows (row i - 1, cell w;
    only rows 1..last are read).

    Iteration k of the kernel puts the band's cell pair g on row k - g.
    Thread ``lane`` holds pairs lane * P .. lane * P + P - 1 (P = C/2); the
    thread holding an odd pair g joins that pair's nibble with pair g - 1's
    of the iteration before (its own, or from the thread to its left) into
    byte g // 2 of row k - g in a ring of max(128, Wp / 2 + 32) rows (160
    at C = 8, 288 at C = 16), and every 32 iterations the 32 rows that have
    become whole are copied out; the rows left in the ring follow at the
    end, then zeros.  A nibble of a cell
    off its rows is poison (0xA), the ring and the output start as poison,
    and an iteration the kernel runs unpredicated asserts that every byte it
    writes lies on a row of the lane.

    Past 512 each warp of the wide lane does this for its 512-cell slice
    (:func:`_move_rows_slice`), past 3072 each warp of each block of the
    cluster lane, a padding slice's writing nothing.
    """
    C, Wp = band_cells(W)
    if W > SLICE_W:
        out = np.full((S, W // 16), -0x22222223, np.int32)     # poison
        for k in range(Wp // SLICE_W):
            _move_rows_slice(codes, last, S, W, k, out)
        return out
    P = C // 2
    R = max(128, Wp // 2 + 32)
    half, rb = W // 2, W // 4
    ring = np.full(R * rb, 0xEE, np.uint8)
    out = np.full(S * rb, 0xDD, np.uint8)
    codes = np.asarray(codes, np.int64)
    lanes = np.arange(32)
    g = lanes[:, None] * P + np.arange(P)[None, :]
    prev = np.zeros((32, P), np.int64)
    flushed = 0
    k_end = last + half - 1 if last > 0 else 0
    for k in range(1, k_end + 1):
        edge = k <= half - 1 or k > last
        row = k - g
        on = (row >= 1) & (row <= last) & (2 * g + 1 < W)
        rr = np.clip(row - 1, 0, S - 1)
        gg = np.clip(g, 0, W // 2 - 1)
        nib = np.where(on, codes[rr, 2 * gg] | (codes[rr, 2 * gg + 1] << 2),
                       0xA)
        left = np.concatenate([prev[:1, P - 1], prev[:-1, P - 1]])
        for p in range(P):
            odd = ((lanes * P + p) & 1) == 1
            low = prev[:, p - 1] if p > 0 else left
            m = g[:, p] >> 1
            mine = odd & (4 * m < W)
            in_rows = (row[:, p] >= 1) & (row[:, p] <= last)
            if edge:
                mine &= in_rows
            else:
                assert in_rows[mine].all(), (k, p)
            slot = ((row[:, p] - 1) % R) * rb + m
            ring[slot[mine]] = ((low | (nib[:, p] << 4)) & 0xFF)[mine]
        prev = nib
        if k - half + 1 - flushed >= 32:
            s0 = (flushed % R) * rb
            out[flushed * rb:(flushed + 32) * rb] = ring[s0:s0 + 32 * rb]
            flushed += 32
    s0 = (flushed % R) * rb
    out[flushed * rb:last * rb] = ring[s0:s0 + (last - flushed) * rb]
    out[last * rb:] = 0
    return out.view("<i4").reshape(S, W // 16)


def _move_rows_slice(codes: np.ndarray, last: int, S: int, W: int, k: int,
                     out: np.ndarray):
    """Warp k of a wide lane writes the words of its slice, cells [512k,
    512k + 512), of every row into ``out`` [S, W/16] int32, as the kernel
    does: 16 cells a thread (8 pairs, so every nibble joins its thread's
    own), a ring of 288 rows of 128 bytes, and a flush of 32 rows once
    min(k_iter - g_hi, last) - flushed >= 32, g_hi the slice's last real
    cell pair; the rows left in the ring after the last iteration, then
    zeros past ``last`` (the lane's warps share those rows: here each writes
    its slice of them)."""
    P, R, rb = 8, 288, SLICE_W // 4
    half = W // 2
    codes = np.asarray(codes, np.int64)
    m0 = k * rb                                  # the slice's first byte
    # its words in a row (none for a slice of padding cells only)
    nw = max(min(SLICE_W // 16, W // 16 - m0 // 4), 0)
    g_hi = min(k * (SLICE_W // 2) + SLICE_W // 2 - 1, half - 1)
    ring = np.full(R * rb, 0xEE, np.uint8)
    dst = out.view(np.uint8).reshape(S, W // 4)
    g = (k * 32 + np.arange(32))[:, None] * P + np.arange(P)[None, :]
    prev = np.zeros((32, P), np.int64)
    flushed = 0

    def flush(n):
        rows = ring.reshape(R, rb)[flushed % R:flushed % R + n]
        dst[flushed:flushed + n, m0:m0 + 4 * nw] = rows[:, :4 * nw]

    odd = np.arange(1, P, 2)
    k_end = last + half - 1 if last > 0 else 0
    # the slice's pairs meet rows 1..last in iterations g_lo + 1 ..
    # g_hi + last; no other iteration writes, so only its flushes run, and
    # none before g_hi + 32
    first, top = k * (SLICE_W // 2) + 1, min(k_end, g_hi + last)
    for it in range(min(first, g_hi + 1), k_end + 1):
        if first <= it <= top:
            edge = it <= half - 1 or it > last
            row = it - g
            on = (row >= 1) & (row <= last) & (2 * g + 1 < W)
            rr = np.clip(row - 1, 0, S - 1)
            gg = np.clip(g, 0, W // 2 - 1)
            nib = np.where(on, codes[rr, 2 * gg] | (codes[rr, 2 * gg + 1]
                                                    << 2), 0xA)
            m = g[:, odd] >> 1
            mine = 4 * m < W
            in_rows = (row[:, odd] >= 1) & (row[:, odd] <= last)
            if edge:
                mine &= in_rows
            else:
                assert in_rows[mine].all(), it
            assert ((m - m0 >= 0) & (m - m0 < rb))[mine].all()
            slot = ((row[:, odd] - 1) % R) * rb + m - m0
            ring[slot[mine]] = ((prev[:, odd - 1] | (nib[:, odd] << 4))
                                & 0xFF)[mine]
            prev = nib
        elif it > top and min(it - g_hi, last) - flushed < 32:
            break                                # no flush is left either
        if min(it - g_hi, last) - flushed >= 32:
            flush(32)
            flushed += 32
    assert last - flushed < 32
    flush(last - flushed)
    dst[last:, m0:m0 + 4 * nw] = 0


def walk_rows_words(moves: np.ndarray, seg_qlen: np.ndarray,
                    w_end: np.ndarray, W: int):
    """The row walk as ``csrc/cns_walk.cu``'s ``walk_rows_kernel`` takes a
    step, on numpy arrays: a row's exit is the highest non-horizontal cell
    of word j = w >> 4 at or left of w (the word masked by 0xffffffff >> (30
    - 2 (w & 15))), else the highest of word j - 1, else that of the first
    word below with one, searched downwards (none: the path broke); packed
    as column 16q + bit/2 and the code at that bit.  Same arguments and
    results as ``ops.align.traceback_rows_plain``, as numpy int32.
    """
    words = np.asarray(moves).view(np.uint32).astype(np.int64)
    n, S, _ = words.shape
    lanes = np.arange(n)
    nh = lambda x: ~(x & (x >> 1)) & 0x55555555
    rows = np.clip(np.asarray(seg_qlen, np.int64), 0, S)
    w = np.asarray(w_end, np.int64)
    w = np.where((w >= 0) & (w < W), w, 0)
    mv = np.full((n, S), -1, np.int32)
    h = np.zeros((n, S), np.int32)
    wo = np.full((n, S), -1, np.int32)
    alive = np.ones(n, bool)
    for i in range(S - 1, -1, -1):
        r = words[:, i, :]
        j = w >> 4
        x1 = r[lanes, j]
        x0 = r[lanes, np.maximum(j - 1, 0)]
        y1 = nh(x1) & (0xFFFFFFFF >> (30 - 2 * (w & 15)))
        y0 = np.where(j > 0, nh(x0), 0)
        x = np.where(y1 != 0, x1, x0)
        y = np.where(y1 != 0, y1, y0)
        q = np.where(y1 != 0, j, j - 1)
        act = alive & (i < rows)
        for k in np.flatnonzero(act & (y == 0)):     # the search down
            for u in range(j[k] - 2, -1, -1):
                if nh(r[k, u]):
                    x[k], y[k], q[k] = r[k, u], nh(r[k, u]), u
                    break
        bit = np.where(y > 0, np.floor(np.log2(np.maximum(y, 1))), 0
                       ).astype(np.int64)
        col, code = 16 * q + (bit >> 1), (x >> bit) & 3
        found = act & (y != 0)
        mv[found, i] = code[found]
        h[found, i] = (w - col)[found]
        wo[found, i] = col[found]
        w_next = np.where(code == 2, np.where(col + 1 < W, col + 1, 0), col)
        w = np.where(found, w_next, w)
        alive &= ~(act & (y == 0))
    return mv, h, wo, w.astype(np.int32)


class _Tape:
    """One lane's tape as ``csrc/cns_walk.cu``'s ``Tape`` writes it into a
    flat buffer of every lane's bytes: backwards from column maxc - 1, the
    bytes in a 64-bit register (the lowest column at its low end), an
    emission of 1-4 bytes completing at most one word, which is stored
    whole (asserted to lie in the lane's tape), byte by byte where it
    reaches into a neighbour's; the word below column 0 at the end."""

    def __init__(self, buf: np.ndarray, base: int, maxc: int):
        self.buf, self.base, self.maxc = buf, base, maxc
        self.col, self.sh0, self.pack = maxc - 1, base & 3, 0

    def emit(self, data: int, k: int):
        assert 1 <= k <= 4 and self.col - k >= -1
        self.pack = ((self.pack << (8 * k)) | data) & (2 ** 64 - 1)
        hi = self.col
        self.col -= k
        zc = hi - ((self.sh0 + hi) & 3)
        if zc > self.col:
            word = (self.pack >> (8 * (zc - self.col - 1))) & 0xFFFFFFFF
            if zc + 3 < self.maxc:
                assert zc >= 0 and (self.base + zc) % 4 == 0
                self.buf[self.base + zc:self.base + zc + 4] = np.frombuffer(
                    word.to_bytes(4, "little"), np.uint8)
            else:
                for u in range(zc, self.maxc):
                    self.buf[self.base + u] = (word >> (8 * (u - zc))) & 0xFF

    def run(self, v: int, n: int):
        word = (v & 0xFF) * 0x01010101
        while n >= 4:
            self.emit(word, 4)
            n -= 4
        if n:
            self.emit(word >> (8 * (4 - n)), n)

    def finish(self):
        assert self.col == -1
        for u in range(min(3 - ((self.sh0 + 3) & 3), self.maxc)):
            self.buf[self.base + u] = (self.pack >> (8 * u)) & 0xFF


def walk_cols_rows(moves: np.ndarray, seg_qlen: np.ndarray,
                   w_end: np.ndarray, W: int, max_cols: int = 0):
    """The column walk as ``csrc/cns_walk.cu``'s ``walk_cols_kernel`` steps
    it, on numpy arrays: a row at a time, not a column.  The common step, at
    row i (1-based) and column w in [0, W): the row's exit is the highest
    non-horizontal cell <= w in w's own word masked at w or in the word
    below, the run of w - exit horizontal codes is at most 3, fits the tape
    and completes no word shared with the next lane's tape; it emits the
    run, then the exit code, at once.  A lane whose step is another takes
    the full step there and for the rest of its group of 8 rows: the exit
    down the row's words (as :func:`walk_rows_words` searches), else on
    down the flat, clipped reads of the reference's
    ``_read_move`` (word (i-1)*W/16 + floor(w/16) clipped to the lane, cell
    w mod 16), at most as far as the tape has room (word 0 read again and
    again below the lane, all horizontal, has no exit); a column outside
    [0, W) and rows above S read that way from the start.  Once at row 0
    the walk emits max(w - W/2, 0) horizontal codes; it stops after exactly
    MAXC columns.  The tape is written by :class:`_Tape`, the lanes' tapes
    side by side in one buffer as the kernel's are.

    Returns (ops int8 [n, MAXC], n_cols int32 [n]) as
    ``ops.align.traceback_ops_plain``'s first and last results; MAXC =
    max_cols if given, else 2*S + W.
    """
    words = np.asarray(moves).view(np.uint32).astype(np.int64)
    n, S, NW = words.shape
    maxc = max_cols if max_cols else 2 * S + W
    half, last = W // 2, S * NW - 1
    flat = words.reshape(n, S * NW)
    nh = lambda x: ~(x & (x >> 1)) & 0x55555555
    buf = np.full(n * maxc, 0xAA, np.uint8)              # poison
    n_cols = np.zeros(n, np.int32)

    def search_flat(b, i, w, budget):
        idx = ((i - 1) * NW + (w >> 4) + 2 ** 31) % 2 ** 32 - 2 ** 31
        bit_w, h = w & 15, 0
        while h < budget:
            x = flat[b, min(max(idx, 0), last)]
            y = nh(x) & (0xFFFFFFFF >> (30 - 2 * bit_w))
            if y:
                bit = int(y).bit_length() - 1
                return h + bit_w - (bit >> 1), int((x >> bit) & 3)
            h += bit_w + 1
            if idx < 0 and bit_w == 15:
                return budget, 0
            bit_w, idx = 15, idx - 1
        return budget, 0

    for b in range(n):
        tape = _Tape(buf, b * maxc, maxc)
        st = dict(i=int(seg_qlen[b]), w=int(w_end[b]), s=0)
        st["walking"] = st["i"] >= 0

        def slow_step(row):
            i, w, rem = st["i"], st["w"], maxc - st["s"]
            if row is not None and 0 <= w < W:
                j = w >> 4
                y, q = nh(row[j]) & (0xFFFFFFFF >> (30 - 2 * (w & 15))), j
                for u in range(j - 1, -1, -1):
                    if y:
                        break
                    y, q = nh(row[u]), u
                if y:
                    bit = int(y).bit_length() - 1
                    h, code = w - (16 * q + (bit >> 1)), int((row[q] >> bit)
                                                             & 3)
                else:
                    h, code = search_flat(b, i, -1, rem - (w + 1))
                    h += w + 1
            else:
                h, code = search_flat(b, i, w, rem)
            if h >= rem:
                tape.run(3, rem)
                st["s"] += rem
                st["walking"] = False
                return
            tape.run(3, h)
            tape.emit(code, 1)
            st["s"] += h + 1
            st["i"] -= 1
            st["w"] += (1 if code == 2 else 0) - h
            st["walking"] = st["s"] < maxc

        while st["walking"] and st["i"] > S:
            slow_step(None)
        stopped = False              # the group's rest is a full step each
        for r in range(S - 1, -1, -1):
            if r % 8 == 7:
                stopped = False
            if not (st["walking"] and st["i"] == r + 1):
                continue
            row, w = flat[b, r * NW:(r + 1) * NW], st["w"]
            j = w >> 4 if 0 <= w < W else 0
            y1 = (nh(row[j]) & (0xFFFFFFFF >> (30 - 2 * (w & 15)))
                  if 0 <= w < W else 0)
            y0 = nh(row[j - 1]) if j > 0 else 0
            x, y, q = (row[j], y1, j) if y1 else (row[max(j - 1, 0)], y0,
                                                 j - 1)
            bit = int(y).bit_length() - 1
            col = 16 * q + (bit >> 1)
            h = w - col
            zc = tape.col - ((tape.sh0 + tape.col) & 3)
            top_word = zc > tape.col - (h + 1) and zc + 3 >= maxc
            if (not stopped and 0 <= w < W and y and h <= 3
                    and h < maxc - st["s"] and not top_word):
                code = int((x >> bit) & 3)
                tape.emit(code | ((0x030303 >> (8 * (3 - h))) << 8), h + 1)
                st["s"] += h + 1
                st["i"] -= 1
                st["w"] = col + (1 if code == 2 else 0)
                st["walking"] = st["s"] < maxc
            else:
                stopped = True
                slow_step(row)
        if st["walking"] and st["i"] == 0:                # row 0
            e = min(max(st["w"] - half, 0), maxc - st["s"])
            tape.run(3, e)
            st["s"] += e
        tape.run(0xFF, tape.col + 1)                     # -1 before the tape
        tape.finish()
        n_cols[b] = st["s"]
    assert not (buf == 0xAA).any()                     # every byte written
    return buf.view(np.int8).reshape(n, maxc).copy(), n_cols


def deposit_scan_warp(wo, aw, h, mv, vbase, delta, keep_ins, W: int):
    """The deposit as ``csrc/cns_walk.cu``'s ``walk_deposit_kernel`` makes
    it, on numpy arrays: each lane's rows in passes of 32; a base at char c
    keeps the least key ``(2*row + 1) << 8 | (vbase & 0xff)``, a gap mark
    ``(2*row) << 8``; the pass's gap cells are numbered by a prefix sum of
    the 32 rows' counts and cell c finds its row by the kernel's binary
    search over the sums; the insertion pack and count take OR and max.
    Same arguments and results as ``ops.consensus_banded.
    deposit_scan_plain``, as numpy.
    """
    wo, aw, h, mv, vbase, delta = (np.asarray(a, np.int64) for a in
                                   (wo, aw, h, mv, vbase, delta))
    keep_ins = np.asarray(keep_ins, bool)
    n, S = wo.shape
    half = W // 2
    LP = S + half - 1
    none = 0x7FFFFFFF
    key = np.full((n, LP), none, np.int64)
    ap = np.zeros((n, LP), np.int64)
    ac = np.zeros((n, LP), np.int64)
    lanes = np.arange(n)[:, None]
    for i0 in range(0, S, 32):
        i = np.arange(i0, i0 + 32)[None, :].repeat(n, 0)
        ok = i < S
        ic = np.minimum(i, S - 1)
        take = lambda a: np.take_along_axis(a, ic, 1)
        o, a, hh, m, vb, d = (take(x) for x in (wo, aw, h, mv, vbase, delta))
        kp = take(keep_ins) & ok
        off = i - half
        base = ok & ((m == 0) | (m == 1)) & (o >= 0) & (o < W) & (off + o >= 0)
        np.minimum.at(key, (lanes.repeat(32, 1)[base], (off + o)[base]),
                      (((2 * i + 1) << 8) | (vb & 0xFF))[base])
        hi = (o + hh + 2 ** 31) % 2 ** 32 - 2 ** 31     # int32 wrap
        lo = np.maximum(np.maximum(o + 1, -off), 0)
        top = np.minimum(hi, W - 1)
        gaps = ok & (m >= 0) & (o < W - 1) & (top >= lo)
        cnt = np.where(gaps, top - lo + 1, 0)
        incl = np.cumsum(cnt, axis=1)
        first = np.where(gaps, off + lo, 0) - (incl - cnt)
        gap_key = np.where(gaps, (2 * i) << 8, 0)
        total = incl[:, -1]
        for c0 in range(0, int(total.max(initial=0)), 32):
            c = c0 + np.arange(32)[None, :].repeat(n, 0)
            row = np.zeros((n, 32), np.int64)
            for step in (16, 8, 4, 2, 1):
                row += np.where(np.take_along_axis(incl, row + step - 1, 1)
                                <= c, step, 0)
            row &= 31
            ch = np.take_along_axis(first, row, 1) + c
            live = c < total[:, None]
            np.minimum.at(key, (lanes.repeat(32, 1)[live], ch[live]),
                          np.take_along_axis(gap_key, row, 1)[live])
        ins = kp & (d >= 1) & (a >= 0) & (a < W) & (off + a >= 0)
        pack = ins & (d <= 15)
        shifted = (vb << (2 * np.clip(d - 1, 0, 14))) & 0xFFFFFFFF
        np.bitwise_or.at(ap, (lanes.repeat(32, 1)[pack], (off + a)[pack]),
                         shifted[pack])
        np.maximum.at(ac, (lanes.repeat(32, 1)[ins], (off + a)[ins]), d[ins])
    val0 = np.where(key == none, -1, np.where(
        (key >> 8) & 1, (key & 0xFF).astype(np.uint8).view(np.int8), 4))
    return (val0.astype(np.int8), ap.astype(np.uint32).view(np.int32),
            ac.astype(np.int32))


def deposit_rows_inputs(S: int, W: int, B: int, L_s: int, seed: int,
                        source: str = "walk", segs=(3, 2), walk=None):
    """Both directions' row walks as ``ops/align.rows_from_moves`` hands
    them to the deposit, with the support windows and seeds.

    ``"walk"``: rows shaped like a walk's (VERT runs between diagonal
    moves, h == 0 inside a run and now and then a few trailing deletions
    that end one, the target count j never falling, rows above a lane's
    top and, on some lanes, below a break not visited); bases 0-3.
    ``"random"``: mv in [-1, 3] (half the rows VERT), h in [0, W + 3]
    (half the rows 0), wo in [-2, W + 1], bases
    0-255 (so base << 2(d-1) wraps in int32).  Both have lanes that are not
    ok and seeds and offsets whose support slice starts below 0 (wrapping)
    and past L_s + S (clamping); ``"walk"`` at S >= 64 and B >= 6 also has,
    on lanes (g, b): (0, 0) right, a side-band run of 18 rows from row 0
    (j == 0); (0, 1) left, one of 18 rows up to row S - 1 (j == j_end);
    (1, 2-4) runs over rows 25-44, across a 32-row pass; (1, 5) two runs,
    28-31 and 32-35, that a deletion at row 31 splits at the pass border,
    and a run up to row S - 1; (0, 5) not ok.  ``segs`` right and left
    segments: G * B lanes need not fill a block's 8 warps.  ``walk`` =
    (mv, h, wo) numpy int32 [n, S] of a row walk, n >= (G_r + G_l) * B:
    its rows in place of the generated ones, the right lanes' first.

    Returns numpy (right_rows, left_rows, q uint8 [B, L_s], qseed int32
    [B]); each rows tuple is (mv, h, wo int32 [G, B, S], w0, qoff, toff
    int32 [G, B], ok bool [G, B]).
    """
    rng = np.random.default_rng(seed)
    half = W // 2
    i_idx = np.arange(S)

    def direction(G: int, left: bool):
        shape = (G, B, S)
        if walk is not None:
            lo = segs[0] * B if left else 0
            mv, h, wo = (np.asarray(a)[lo:lo + G * B].reshape(shape)
                         for a in walk)
        elif source == "random":
            mv = np.where(rng.random(shape) < 0.5, 2,
                          rng.integers(-1, 4, shape))
            h = np.where(rng.random(shape) < 0.5, 0,
                         rng.integers(0, W + 4, shape))
            wo = rng.integers(-2, W + 2, shape)
        else:
            mv = np.where(rng.random(shape) < 0.35, 2,
                          rng.integers(0, 2, shape))
            h = np.where(rng.random(shape) < 0.1,
                         rng.integers(1, 4, shape), 0)
            if S >= 64 and B >= 6:
                run = slice(25, 45)
                mv[1, 2:5, run] = 2
                h[1, 2:5, run] = 0
                mv[1, 5, 28:36] = 2
                h[1, 5, 28:36] = 0
                h[1, 5, 31] = 2
                mv[1, 5, S - 7:] = 2
                h[1, 5, S - 7:] = 0
                if left:
                    mv[0, 1, S - 19:] = 2
                    h[0, 1, S - 18:] = 0
                    mv[0, 1, S - 19] = 0
                else:
                    mv[0, 0, :19] = 2
                    h[0, 0, :18] = 0
                    mv[0, 0, 18] = 0
            j0 = rng.integers(-1, 3, (G, B, 1))
            if S >= 64 and B >= 6 and not left:
                j0[0, 0] = 0
            diag = (mv == 0) | (mv == 1)
            before = np.cumsum(h, axis=2) - h       # deletions below row i
            j = j0 + np.cumsum(diag, axis=2) + before
            wo = j - (i_idx + 1) + half
            top = rng.integers(S // 2, S + 1, (G, B, 1))
            top[rng.random((G, B, 1)) < 0.4] = S
            brk = np.where(rng.random((G, B, 1)) < 0.15,
                           rng.integers(1, 8, (G, B, 1)), 0)
            if S >= 64 and B >= 6:
                top[:2, :6], brk[:2, :6] = S, 0
            gone = (i_idx >= top) | (i_idx < brk)
            mv = np.where(gone, -1, mv)
            wo = np.where(gone, rng.integers(-W, 2 * W, shape), wo)
        w0 = rng.integers(0, W + 1, (G, B))
        qoff = rng.integers(-2 * S - L_s, 2 * S + L_s + 1, (G, B))
        if source == "walk":
            qoff = rng.integers(0, L_s + 1, (G, B))
        toff = np.cumsum(rng.integers(S // 2, S + 1, (G, B)), axis=0)
        ok = rng.random((G, B)) < 0.8
        if B >= 6:
            ok[:2, :5] = True
            ok[0, 5] = False
        if B >= 3:
            # the slice start: wrapped then inside, past L_s + S, below 0
            qoff[0, :3] = ((S + 7, L_s + S + 5, 3 * S + L_s) if left
                           else (L_s + S + 5, -2 * S, 0))
        return tuple(a.astype(np.int32) for a in (mv, h, wo, w0, qoff, toff)
                     ) + (ok,)

    right = direction(segs[0], False)
    left = direction(segs[1], True)
    q = rng.integers(0, 256 if source == "random" else 4, (B, L_s)).astype(
        np.uint8)
    qseed = rng.integers(0, max(L_s, 1), B).astype(np.int32)
    if B >= 3:
        qseed[:3] = (0, max(L_s - 1, 0), 1)
    return right, left, q, qseed


def _deposit_rowinfo_warp(rows, q, qseed, S: int, W: int, left: bool):
    """One direction's row information as the deposit kernel makes it, on
    numpy: j_end by one reduction pass over each lane's rows, the query
    chars from the wrapped and clamped slice start, and the run positions
    in passes of 32 rows with carries: up the rows for a right lane (a
    max-scan of run starts, the last start carried), down them for a left
    lane (a min-scan of run ends from the top, the first end carried).
    Returns (info dict of [G, B, S] arrays, bnd_pack, bnd_cnt, j_end, lead
    [G, B]) as ``ops.consensus_banded.direction_rowinfo`` returns them."""
    mv, h, wo, w0, qoff, _, ok = (np.asarray(a) for a in rows)
    G, B, _ = mv.shape
    L_s = q.shape[1]
    half = W // 2
    n = G * B
    mv, h, wo = (np.asarray(a, np.int64).reshape(n, S) for a in (mv, h, wo))
    okx = np.asarray(ok, bool).reshape(n, 1)
    b = np.arange(n) % B
    i_idx = np.arange(S)[None, :]
    je = np.where(mv >= 0, _i32(_i32(i_idx + 1 - half + wo) + h),
                  -1).max(axis=1)
    qs, qo = np.asarray(qseed, np.int64)[b], np.asarray(qoff,
                                                         np.int64).ravel()
    start = _i32(qs - qo) if left else _i32(S + qs + qo)
    start = np.clip(np.where(start < 0, start + L_s + 2 * S, start), 0,
                    L_s + S)
    c = (start[:, None] + (S - 1 - i_idx if left else i_idx)) - S
    inside = (c >= 0) & (c < L_s)
    vb = np.where(inside, np.asarray(q, np.int64)[
        b[:, None], np.clip(c, 0, max(L_s - 1, 0))] if L_s else 0, 0)

    delta = np.zeros((n, S), np.int64)
    passes = (S + 31) // 32
    carry_idx = np.full(n, S if left else -1)
    carry_v = np.zeros(n, bool)
    carry_h0 = np.ones(n, bool)
    for p in (range(passes - 1, -1, -1) if left else range(passes)):
        i = p * 32 + np.arange(32)[None, :]
        live = i < S
        ic = np.minimum(i, S - 1).repeat(n, 0)
        m, hh = (np.take_along_axis(a, ic, 1) for a in (mv, h))
        isv = live & (m == 2)
        if not left:
            below_v = np.concatenate([carry_v[:, None], isv[:, :-1]], 1)
            below_h0 = np.concatenate([carry_h0[:, None], hh[:, :-1] == 0],
                                      1)
            s = np.where(isv & ~(below_v & below_h0), i, -1)
            s = np.maximum(np.maximum.accumulate(s, 1), carry_idx[:, None])
            d = np.where(isv, i - s + 1, 0)
            carry_idx, carry_v, carry_h0 = s[:, 31], isv[:, 31], hh[:, 31] == 0
        else:
            above_v = np.concatenate([isv[:, 1:], carry_v[:, None]], 1)
            e = np.where(isv & ~(above_v & (hh == 0)), i, S)
            e = np.minimum(np.minimum.accumulate(e[:, ::-1], 1)[:, ::-1],
                           carry_idx[:, None])
            d = np.where(isv, e - i + 1, 0)
            carry_idx, carry_v = e[:, 0], isv[:, 0]
        cols = i[0, live[0]]
        delta[:, cols] = d[:, live[0]]

    j = _i32(i_idx + 1 - half + wo)
    isv = mv == 2
    side = isv & (j == (je[:, None] if left else 0))
    sb = side & okx
    bnd_cnt = np.where(sb, delta, 0).max(axis=1)
    bits = np.where(sb & (delta <= C.MAX_INS_DELTA),
                    (vb << (2 * np.clip(delta - 1, 0, C.MAX_INS_DELTA - 1)))
                    & 0xFFFFFFFF, 0)
    bnd_pack = np.bitwise_or.reduce(bits, axis=1)
    info = dict(wo=wo, aw=_i32(wo + 1) if left else wo,
                h=np.where(okx, h, 0), mv=np.where(okx, mv, -1), vbase=vb,
                delta=delta, keep_ins=isv & ~side & okx)
    info = {k: (v if k == "keep_ins" else v.astype(np.int32)).reshape(
        G, B, S) for k, v in info.items()}
    lead = np.maximum(_i32(np.asarray(w0, np.int64) - half), 0)
    flat = lambda a: np.asarray(a, np.int64).reshape(G, B)
    return (info, flat(bnd_pack).astype(np.uint32).view(np.int32),
            flat(bnd_cnt).astype(np.int32), flat(je).astype(np.int32),
            lead.astype(np.int32))


def deposit_rows_warp(right_rows, left_rows, q, qseed, S: int, W: int):
    """The deposit kernel with its row information (``csrc/cns_walk.cu``'s
    ``walk_deposit_kernel``), on numpy: each direction's row information in
    the kernel's passes (:func:`_deposit_rowinfo_warp`), then the deposit's
    own order (:func:`deposit_scan_warp`) over the right lanes, then the
    left.  Returns (infos (right, left), and the arguments (planes_r,
    planes_l, side_r, side_l, lj_end) that ``ops.consensus_banded.
    plane_inputs`` returns), as numpy."""
    infos, sides = [], []
    for rows, left in ((right_rows, False), (left_rows, True)):
        info, bp, bc, je, lead = _deposit_rowinfo_warp(rows, q, qseed, S, W,
                                                       left)
        infos.append(info)
        sides.append(((np.asarray(rows[5]), np.asarray(rows[6]), lead, bp,
                       bc), je))
    keys = ("wo", "aw", "h", "mv", "vbase", "delta", "keep_ins")
    planes = deposit_scan_warp(*(np.concatenate(
        [i[k].reshape(-1, S) for i in infos]) for k in keys), W)
    G_r, B = infos[0]["wo"].shape[:2]
    cut = lambda lo, hi, G: tuple(p[lo:hi].reshape(G, B, -1) for p in planes)
    G_l = infos[1]["wo"].shape[0]
    return infos, (cut(0, G_r * B, G_r), cut(G_r * B, None, G_l),
                   sides[0][0], sides[1][0], sides[1][1])


#: the planes kernel's tile of columns (``csrc/cns_fold.cu`` kPlanesTile)
PLANES_TILE = 1024


def fold_inputs(S: int, W: int, B: int, L_t: int, T: int, seed: int,
                tile: int = PLANES_TILE, segs=(6, 5)):
    """Edge inputs of the tag fold's two kernels, as :func:`..ops.
    consensus_banded.plane_inputs` and the chunk hand them over: deposit
    planes (val0 in [-1, 4], ipack any int32, icnt 0-20), segments whose
    target offsets grow by S/2 to S (a prefix of them ok, each left j_end
    within its segment's step, so side-band cells run in column order),
    side-band packs and counts, and the pair arrays of the fold.  Pairs 0-11
    are edge pairs: 0-2 tseed at 0, at L_t and past it; 3 a non-ok segment
    between ok ones in each direction; 4 the first right window start
    clamped at 0 and the last at LG - LP; 5 a same-cell side-band chain
    from the left direction's last entry into the right's first two, which
    share one offset; 6 that chain with a run count of 13 at its cell, so
    its second entry starts at off >= MAXD; 7 that chain on an unconsumed
    anchor (g0 < 0); 8 tend > tlen; 9 tlen and tend past L_t (b == L_t); 10
    that chain summing past 15 deltas (gcnt > 15); 11 a masked pair (B >=
    12), the first pair of slot T - 1 (T >= 2), which pair 17 shares.  With
    B >= 18, for tiles of ``tile`` columns: 12-14 on slot 0, kept, masked,
    kept; 15 and 16 the chain of pair 5 at a tile's last column and at the
    next tile's first (tseed tile and tile + 1; where L_t <= tile + 1 at
    the last column and at column 0); 17 tseed inside a tile.  ``segs``
    right and left segments (at least 3 and 2; past 32 the kernel's lanes
    take them in rounds).

    Returns a dict of numpy arrays: planes_r / planes_l (val0 int8, ipack,
    icnt int32 [G, B, LP]), side_r / side_l (toff, ok bool, lead, bnd_pack,
    bnd_cnt [G, B]), lj_end [G_l, B], tseed, tlen, t_slot, tbeg, tend int32
    and pair_ok bool [B], counts int32 [T, L_t, 16, 5] and cov_diff int32
    [T, L_t + 1] (small random starting values).
    """
    rng = np.random.default_rng(seed)
    LP = S + W // 2 - 1
    LG = L_t + LP + S
    G_r, G_l = segs

    def direction(G):
        v0 = rng.choice(np.array([-1, 0, 1, 2, 3, 4], np.int8), (G, B, LP),
                        p=[0.2, 0.2, 0.15, 0.15, 0.15, 0.15])
        ip = rng.integers(-(1 << 31), 1 << 31, (G, B, LP)).astype(np.int32)
        ic = np.where(rng.random((G, B, LP)) < 0.8, 0, rng.integers(
            1, 21, (G, B, LP))).astype(np.int32)
        step = rng.integers(S // 2, S + 1, (G, B)).astype(np.int32)
        toff = (np.cumsum(step, axis=0) - step).astype(np.int32)
        n_ok = rng.integers(0, G + 1, B)
        ok = np.arange(G)[:, None] < n_ok[None, :]
        lead = rng.integers(0, W // 2, (G, B)).astype(np.int32)
        bp = rng.integers(0, 1 << 30, (G, B)).astype(np.int32)
        bc = np.where(rng.random((G, B)) < 0.5, 0,
                      rng.integers(1, 21, (G, B))).astype(np.int32)
        return [v0, ip, ic], [toff, ok, lead, bp, bc], step

    planes_r, side_r, _ = direction(G_r)
    planes_l, side_l, step_l = direction(G_l)
    lj_end = (step_l - rng.integers(0, 3, (G_l, B))).astype(np.int32)
    lj_end[rng.random((G_l, B)) < 0.1] = -1
    tseed = rng.integers(0, L_t, B).astype(np.int32)
    tseed[0], tseed[1], tseed[2] = 0, L_t, L_t + 7
    for side in (side_r, side_l):
        side[1][:, 3] = True
        side[1][1, 3] = False                    # a non-ok segment inside
    side_r[1][:, 4] = True
    side_r[0][:, 4] -= 37                        # clamped at 0 ...
    side_r[0][-1, 4] = LG - LP + 50              # ... and at LG - LP
    chains = [(5, 3, (4, 5)), (6, 13, (2, 3)), (7, 3, (4, 5)),
              (10, 10, (5, 3))]
    if B >= 18:
        # the chain's cell is column tseed - 1
        edge = (tile, tile + 1) if tile + 1 < L_t else (L_t, 1)
        tseed[15], tseed[16] = edge
        tseed[17] = tile + tile // 2 if tile + tile // 2 < L_t else L_t // 2
        chains += [(15, 3, (4, 5)), (16, 3, (4, 5))]
    for b, icnt, cnt in chains:
        # the left's last entry and the right's first at global column
        # tseed - 1; the right's first two segments at one offset
        side_l[0][:, b] -= side_l[0][0, b]
        lj_end[0, b] = 0 if b % 2 else -1
        side_r[0][:, b] -= side_r[0][0, b]
        side_r[0][1, b] = 0
        for side in (side_l, side_r):
            side[1][:, b] = True
        side_l[4][0, b], side_r[4][0, b] = cnt
        side_r[4][1, b] = 2
        side_l[2][0, b] = 0
        tseed[b] = max(tseed[b], 1)              # the cell is a column
        tseed[b] = min(tseed[b], L_t)
        planes_l[0][0, b, 0] = -1 if b == 7 else 2
        planes_l[2][0, b, 0] = icnt
    tlen = rng.integers(L_t // 2, L_t + 1, B).astype(np.int32)
    tbeg = (rng.integers(-5, L_t // 2, B)).astype(np.int32)
    tend = (tbeg + rng.integers(1, L_t // 2, B)).astype(np.int32)
    tend[8] = tlen[8] + 20
    tlen[9], tend[9] = L_t + 10, L_t + 20
    pair_ok = rng.random(B) < 0.85
    pair_ok[:11] = True
    pair_ok[11] = False
    t_slot = rng.integers(0, T, B).astype(np.int32)
    if T >= 2:
        t_slot[:11][t_slot[:11] == T - 1] = 0
        t_slot[11] = T - 1
    if B >= 18:
        t_slot[12:15] = 0
        pair_ok[12:18] = True
        pair_ok[13] = False
        t_slot[17] = T - 1
    return dict(planes_r=tuple(planes_r), planes_l=tuple(planes_l),
                side_r=tuple(side_r), side_l=tuple(side_l), lj_end=lj_end,
                tseed=tseed, tlen=tlen, t_slot=t_slot,
                pair_ok=pair_ok, tbeg=tbeg, tend=tend,
                counts=rng.integers(0, 3, (T, L_t, C.MAX_INS_DELTA + 1, 5)
                                    ).astype(np.int32),
                cov_diff=rng.integers(-2, 3, (T, L_t + 1)).astype(np.int32))


#: the planes kernel's and the fold's pair arrays in fold_inputs, in the
#: order of their arguments
PLANE_KEYS = ("planes_r", "planes_l", "side_r", "side_l", "lj_end", "tseed")
FOLD_KEYS = ("tlen", "t_slot", "pair_ok", "tbeg", "tend")


def fold_case(device, S: int, W: int, L_t: int, source: str, B: int = 128,
              T: int = 16, seed: int = 7, segs=(6, 5)):
    """The tag fold's arguments as tensors on ``device``: (the arguments of
    ``ops.consensus_banded.banded_global_planes_plain`` but its keywords,
    [counts, cov_diff, tlen, t_slot, pair_ok, tbeg, tend] of
    ``fold_tags_plain``).  ``"edge"``: :func:`fold_inputs` (``segs``
    right and left segments); ``"path"``: the
    deposit and side arrays of the row walks (``ops.align.
    extend_pair_batch_rows``, L_t // S + 2 segments a direction) of
    :func:`extend_inputs` pairs of L_t bases, as a cns chunk hands them
    over, with the pairs' own spans, the identity gate of the correction
    filter (60 %, 20 columns) and random table slots; zeroed tables."""
    def on(a):
        if isinstance(a, tuple):
            return tuple(on(x) for x in a)
        return torch.as_tensor(np.array(a), device=device)

    if source == "edge":
        fi = fold_inputs(S, W, B, L_t, T, seed, segs=segs)
        return ([on(fi[k]) for k in PLANE_KEYS],
                [on(fi["counts"]), on(fi["cov_diff"]),
                 *(on(fi[k]) for k in FOLD_KEYS)])
    from .ops.align import extend_pair_batch_rows
    from .ops.consensus_banded import plane_inputs

    q, t, qlen, tlen, qs, ts = (on(a) for a in extend_inputs(B, L_t, S,
                                                              seed))
    G = L_t // S + 2
    pa, rr, lr = extend_pair_batch_rows(q, t, qlen, tlen, qs, ts, S=S, W=W,
                                        max_segs=G, max_segs_left=G)
    slot = on(np.random.default_rng(seed).integers(0, T, B).astype(
        np.int32))
    pair_ok = (pa.identity >= 60.0) & ((pa.tend - pa.tbeg) >= 20)
    return [*plane_inputs(rr, lr, q, qs, S, W), ts], [
        torch.zeros((T, L_t, C.MAX_INS_DELTA + 1, 5), dtype=torch.int32,
                    device=device),
        torch.zeros((T, L_t + 1), dtype=torch.int32, device=device),
        tlen, slot, pair_ok, pa.tbeg, pa.tend]


def _i32(x):
    """int64 values wrapped to int32, as int32 tensor arithmetic wraps."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def global_planes_pairwise(planes_r, planes_l, side_r, side_l, lj_end, tseed,
                           L_t: int, S: int, W: int):
    """The global planes found pair by pair, the order of a planes kernel
    with one block a pair (:func:`global_planes_tiled` is the tiled
    kernel's), on numpy arrays: each output column's value found, not
    replayed (the right placement if it covers the column, else the left
    one, flipped; in that direction the highest segment whose clamped
    window holds it: GAP below its lead, the empties where it is not ok or
    none holds it), then the pair's side-band entries (left descending,
    right ascending), each reading the placed planes at its cell, chained
    in order by one loop that writes a group's sum at its last entry where
    that cell is an output column.  Same arguments and results as
    ``ops.consensus_banded.banded_global_planes_plain``, as numpy."""
    planes_r = [np.asarray(a) for a in planes_r]
    planes_l = [np.asarray(a) for a in planes_l]
    side_r = [np.asarray(a) for a in side_r]
    side_l = [np.asarray(a) for a in side_l]
    lj_end, tseed = np.asarray(lj_end), np.asarray(tseed)
    B = len(tseed)
    LP = S + W // 2 - 1
    LG = L_t + LP + S
    Lb = 2 * LG + L_t
    g0 = np.empty((B, L_t), np.int8)
    gp = np.empty((B, L_t), np.int32)
    gc = np.empty((B, L_t), np.int32)

    def window(planes, side, b, u):
        v0, ip, ic = planes
        toff, ok, lead = side[:3]
        val = np.full(u.shape, -1, np.int64)
        pk = np.zeros(u.shape, np.int64)
        cn = np.zeros(u.shape, np.int64)
        found = np.zeros(u.shape, bool)
        for g in range(v0.shape[0] - 1, -1, -1):
            c = u - min(max(int(toff[g, b]), 0), LG - LP)
            hit = ~found & (c >= 0) & (c < LP)
            found |= hit
            if ok[g, b]:
                cc = c[hit]
                val[hit] = np.where(cc < lead[g, b], 4, v0[g, b, cc])
                pk[hit], cn[hit] = ip[g, b, cc], ic[g, b, cc]
        return val, pk, cn

    for b in range(B):
        ts = int(tseed[b])
        rs = min(max(int(_i32(LG + ts)), 0), Lb - LG)
        ls = min(max(ts, 0), Lb - LG)

        def placed(x):
            out = [np.full(x.shape, -1, np.int64),
                   np.zeros(x.shape, np.int64), np.zeros(x.shape, np.int64)]
            r, lf = x - rs, x - ls
            in_r = (r >= 0) & (r < LG)
            in_l = ~in_r & (lf >= 0) & (lf < LG)
            for sel, vals in ((in_r, window(planes_r, side_r, b, r[in_r])),
                              (in_l, window(planes_l, side_l, b,
                                            LG - 1 - lf[in_l]))):
                for o, v in zip(out, vals):
                    o[sel] = v
            return out

        v, p, c = placed(LG + np.arange(L_t))
        g0[b], gp[b], gc[b] = v, p, c
        entries = []
        for g in range(lj_end.shape[0] - 1, -1, -1):
            cell = _i32(LG + ts - 1 - _i32(int(side_l[0][g, b])
                                           + max(int(lj_end[g, b]), 0)))
            entries.append((int(cell), side_l[3][g, b], side_l[4][g, b],
                            side_l[1][g, b]))
        for g in range(side_r[0].shape[0]):
            cell = _i32(LG + ts + int(side_r[0][g, b]) - 1)
            entries.append((int(cell), side_r[3][g, b], side_r[4][g, b],
                            side_r[1][g, b]))
        prep = []
        for cell, pack, cnt, ok in entries:
            cnt = int(cnt) if ok else 0
            base = at_gp = live = 0
            if LG <= cell < LG + L_t:
                at = placed(np.array([cell]))
                base, at_gp = int(at[2][0]), int(at[1][0])
                live = cnt > 0 and at[0][0] >= 0
            prep.append((cell, int(pack), cnt if live else 0, base, live,
                         at_gp))
        acc_cnt = acc_pack = 0
        for k, (cell, pack, cnt, base, live, at_gp) in enumerate(prep):
            if k == 0 or cell != prep[k - 1][0]:
                acc_cnt = acc_pack = 0
            off = int(_i32(base + acc_cnt))
            shift = min(max(int(_i32(2 * off)), 0), 2 * C.MAX_INS_DELTA)
            if live and off < C.MAX_INS_DELTA:
                acc_pack |= ((pack % (1 << 32)) << shift) & ((1 << 30) - 1)
            acc_cnt = int(_i32(acc_cnt + cnt))
            last = k == len(prep) - 1 or prep[k + 1][0] != cell
            if last and acc_cnt > 0:
                gp[b, cell - LG] = _i32(at_gp | acc_pack)
                gc[b, cell - LG] = _i32(base + acc_cnt)
    return g0, gp, gc


def global_planes_tiled(planes_r, planes_l, side_r, side_l, lj_end, tseed,
                        L_t: int, S: int, W: int, tile: int = PLANES_TILE):
    """The global planes as ``csrc/cns_fold.cu``'s planes kernel makes them,
    on numpy arrays, a (pair, tile of ``tile`` columns) at a time: the
    tile's columns in each direction's local columns (the left flipped), the
    segments whose clamped windows meet them listed in segment order, each
    column's last writer the last listed segment whose window holds it
    (right over left, a non-ok segment's empties included), then the
    pair's side-band entries whose cell is a column of the tile, in order
    (a group ends where the cell changes or an entry outside the tile came
    between; the kernel splits them further by the warp that holds the
    cell, which keeps every group whole), each reading the placed value of
    its cell, chained by one loop that writes a group's sum at its last
    entry.  Same arguments and results as ``ops.consensus_banded.
    banded_global_planes_plain``, as numpy."""
    planes_r = [np.asarray(a) for a in planes_r]
    planes_l = [np.asarray(a) for a in planes_l]
    side_r = [np.asarray(a) for a in side_r]
    side_l = [np.asarray(a) for a in side_l]
    lj_end, tseed = np.asarray(lj_end), np.asarray(tseed)
    B = len(tseed)
    LP = S + W // 2 - 1
    LG = L_t + LP + S
    Lb = 2 * LG + L_t
    g0 = np.empty((B, L_t), np.int8)
    gp = np.empty((B, L_t), np.int32)
    gc = np.empty((B, L_t), np.int32)

    def listed(side, b, lo, hi):
        start = np.clip(side[0][:, b].astype(np.int64), 0, LG - LP)
        hit = (start <= hi) & (start + LP > lo) & (lo <= hi)
        return [(int(start[g]), bool(side[1][g, b]), int(side[2][g, b]), g)
                for g in np.nonzero(hit)[0]]

    def search(planes, segs, b, u):
        v0, ip, ic = planes
        val = np.full(u.shape, -1, np.int64)
        pk = np.zeros(u.shape, np.int64)
        cn = np.zeros(u.shape, np.int64)
        found = np.zeros(u.shape, bool)
        for start, ok, lead, g in reversed(segs):
            c = u - start
            hit = ~found & (c >= 0) & (c < LP)
            found |= hit
            if ok:
                cc = c[hit]
                val[hit] = np.where(cc < lead, 4, v0[g, b, cc])
                pk[hit], cn[hit] = ip[g, b, cc], ic[g, b, cc]
        return val, pk, cn

    for b in range(B):
        ts = int(tseed[b])
        rs = min(max(int(_i32(LG + ts)), 0), Lb - LG)
        ls = min(max(ts, 0), Lb - LG)
        entries = []
        for g in range(lj_end.shape[0] - 1, -1, -1):
            cell = _i32(LG + ts - 1 - _i32(int(side_l[0][g, b])
                                           + max(int(lj_end[g, b]), 0)))
            entries.append((int(cell), side_l[3][g, b], side_l[4][g, b],
                            side_l[1][g, b]))
        for g in range(side_r[0].shape[0]):
            cell = _i32(LG + ts + int(side_r[0][g, b]) - 1)
            entries.append((int(cell), side_r[3][g, b], side_r[4][g, b],
                            side_r[1][g, b]))
        for l0 in range(0, L_t, tile):
            l1 = min(l0 + tile, L_t)
            segs_r = listed(side_r, b, max(LG + l0 - rs, 0),
                            min(LG + l1 - 1 - rs, LG - 1))
            lo, hi = max(LG + l0 - ls, 0), min(LG + l1 - 1 - ls, LG - 1)
            segs_l = listed(side_l, b, LG - 1 - hi, LG - 1 - lo)

            def placed(x):
                out = [np.full(x.shape, -1, np.int64),
                       np.zeros(x.shape, np.int64),
                       np.zeros(x.shape, np.int64)]
                r, lf = x - rs, x - ls
                in_r = (r >= 0) & (r < LG)
                in_l = ~in_r & (lf >= 0) & (lf < LG)
                for sel, vals in (
                        (in_r, search(planes_r, segs_r, b, r[in_r])),
                        (in_l, search(planes_l, segs_l, b,
                                      LG - 1 - lf[in_l]))):
                    for o, v in zip(out, vals):
                        o[sel] = v
                return out

            v, p, c = placed(LG + np.arange(l0, l1))
            g0[b, l0:l1], gp[b, l0:l1], gc[b, l0:l1] = v, p, c
            prep = []
            for k, (cell, pack, cnt, ok) in enumerate(entries):
                if not l0 <= cell - LG < l1:
                    continue
                cnt = int(cnt) if ok else 0
                at = placed(np.array([cell]))
                live = cnt > 0 and at[0][0] >= 0
                prep.append((k, cell, int(pack), cnt if live else 0,
                             int(at[2][0]), int(at[1][0])))
            acc_cnt = acc_pack = 0
            for i, (k, cell, pack, cnt, base, at_gp) in enumerate(prep):
                if i == 0 or (cell, k) != (prep[i - 1][1],
                                           prep[i - 1][0] + 1):
                    acc_cnt = acc_pack = 0
                off = int(_i32(base + acc_cnt))
                shift = min(max(int(_i32(2 * off)), 0), 2 * C.MAX_INS_DELTA)
                if cnt > 0 and off < C.MAX_INS_DELTA:
                    acc_pack |= ((pack % (1 << 32)) << shift) & ((1 << 30) - 1)
                acc_cnt = int(_i32(acc_cnt + cnt))
                last = (i == len(prep) - 1
                        or (prep[i + 1][1], prep[i + 1][0]) != (cell, k + 1))
                if last and acc_cnt > 0:
                    gp[b, cell - LG] = _i32(at_gp | acc_pack)
                    gc[b, cell - LG] = _i32(base + acc_cnt)
    return g0, gp, gc


def fold_tags_cells(counts, cov_diff, g0, gpack, gcnt, tlen, t_slot,
                    pair_ok, tbeg, tend, L_t: int):
    """The fold as ``csrc/cns_fold.cu``'s fold kernel does it, on numpy
    arrays: for each pair with pair_ok, one add of 1 a present cell of
    counts[t_slot] (the base channel where 0 <= g0 <= 4; delta d at base
    (gpack >> 2(d-1)) & 3 for d = 1 .. min(gcnt, 15)) over the columns
    below tlen, and +1 / -1 on cov_diff at the clipped span's ends.
    Returns new (counts, cov_diff); same arguments as
    ``ops.consensus_banded.fold_tags_plain``."""
    counts = np.array(counts, np.int32)
    cov_diff = np.array(cov_diff, np.int32)
    g0, gpack, gcnt = (np.asarray(a) for a in (g0, gpack, gcnt))
    for b in np.nonzero(np.asarray(pair_ok))[0]:
        slot = int(t_slot[b])
        n = max(min(int(tlen[b]), L_t), 0)
        cols = np.arange(n)
        v = g0[b, :n].astype(np.int64)
        m = (v >= 0) & (v <= 4)
        np.add.at(counts, (slot, cols[m], 0, v[m]), 1)
        pack = gpack[b, :n].astype(np.int64) % (1 << 32)
        for d in range(1, C.MAX_INS_DELTA + 1):
            m = gcnt[b, :n] >= d
            np.add.at(counts, (slot, cols[m], d,
                               (pack[m] >> (2 * (d - 1))) & 3), 1)
        a = min(max(int(tbeg[b]), 0), L_t)
        e = min(max(min(int(tend[b]), int(tlen[b])), 0), L_t)
        if e > a:
            cov_diff[slot, a] += 1
            cov_diff[slot, e] -= 1
    return counts, cov_diff


class DpTally:
    """A DP segment function for the host loop: ``ops.align.
    dp_segment_best`` itself, counting the lanes of every segment it is
    asked for.  Handing it to an extension routes the loop through the
    host (a wrapper is not ``dp_segment_best``), so the tests hold the
    lane-segments a path counts from its results against it."""

    def __init__(self):
        self.lane_segs = 0

    def __call__(self, q_seg, *args, **kwargs):
        from .ops.align import dp_segment_best

        self.lane_segs += int(q_seg.shape[0])
        return dp_segment_best(q_seg, *args, **kwargs)


def moves_as_the_kernels_leave_them(raw2, G: int, qlen2, tlen2, S: int,
                                    W: int):
    """The raw tuple of ``ops.align._extend_both_with_moves`` run on the
    plain DP, with each segment's move rows past the last row the kernels
    compute, min(seg_q, S, rem_t + W/2), set to zero as the kernels leave
    them (no walk reads them).  ``qlen2`` / ``tlen2`` are the 2B lanes'
    lengths of ``ops.align.direction_lanes``; the first G segments are the
    right direction's."""
    moves2, r2, w2, qo2, to2, ok2 = raw2
    B = moves2.shape[1]
    right = torch.arange(moves2.shape[0], device=moves2.device)[:, None] < G
    qlen = torch.where(right, qlen2[None, :B], qlen2[None, B:])
    tlen = torch.where(right, tlen2[None, :B], tlen2[None, B:])
    seg_q = (qlen - qo2).clamp(0, S)
    rem_t = (tlen - to2).clamp(0, S + W // 2)
    last = torch.minimum(seg_q, rem_t + W // 2)
    row = torch.arange(1, S + 1, device=moves2.device)[None, None, :, None]
    moves = torch.where(row <= last[:, :, None, None], moves2, 0)
    return (moves, r2, w2, qo2, to2, ok2)


def dp_segment_best_wavefront(q_seg: torch.Tensor, tpad: torch.Tensor,
                              tmax: torch.Tensor, seg_q: torch.Tensor,
                              active: torch.Tensor, S: int, W: int,
                              want_moves: bool = False):
    """One DP segment evaluated as ``csrc/dp_segment.cu`` evaluates it.

    Cell (row i, band cell w) is made at step tau = 2*i + w: on an even
    step the even band cells advance one row, on an odd step the odd ones.
    Its diagonal input is the cell's own value (made at tau - 2), the
    vertical and the horizontal input are the right and the left neighbour
    as they stand (made at tau - 1), and the horizontal closure is the
    sequential ``min(cand, left + 4097)``: no scan.  The band holds Wp =
    :func:`band_cells` cells; the cells w >= W are padding, whose target
    index is pushed out of [0, tmax] so that they stay at VINF.  Moves are
    attributed from the values and assembled into words by
    :func:`move_rows_ring`; the best cell is kept per band cell with a
    strict ``>`` (padding cells start below every real one) and reduced
    once on (score desc, r*W + w asc).  The steps whose cells all lie inside
    the target skip the validity select and the clamp, as the kernel's fast
    iterations do, which it runs only without padding.  Rows run to
    ``min(seg_q, S, tmax + W/2)`` (0 for a negative tmax): no later row
    holds a cell that can score.  Same arguments and results as
    ``ops.align.dp_segment_best_plain``, except that the move rows past the
    last row are zero, as the kernel leaves them.

    Past 512 the lane is a warp a 512-cell slice: the value that crosses a
    warp border comes from the slot the neighbouring warp published (its
    first cell after the even step, its last after the odd step; the last
    cells first after row 0), each warp keeps the move ring of its slice,
    and the best cell is reduced in each slice and then across the slices
    in order.  Past 3072 the slices are those of m blocks of p warps
    (:func:`cluster_shape`): the slots are each block's, and the first and
    the last slice of a block read the neighbouring block's; each block
    holds the query's S bytes and S + 512 p target bytes from its first
    cell on, a read outside them clamped in (asserted to happen only off a
    cell's rows 1..last); and the reduction runs over the blocks in rank
    order, each block's slices in order.
    """
    B = q_seg.shape[0]
    half = W // 2
    _, Wp = band_cells(W)
    padded = W < Wp
    wide = W > SLICE_W
    m_blocks, p_warps = cluster_shape(W) if wide else (1, 1)
    cluster = m_blocks > 1
    K1 = IND_K + 1
    w_all = torch.arange(Wp, dtype=torch.int32)
    real = w_all < W
    tm = tmax[:, None]
    jo = torch.where(real, w_all - half, 1 << 30)
    ok0 = (jo[None, :] >= 0) & (jo[None, :] <= tm)
    # val[:, w] = valp[:, w + 1], VINF on either side of the band
    valp = torch.full((B, Wp + 2), VINF, dtype=torch.int32)
    val = valp[:, 1:Wp + 1]
    val[:] = torch.where(ok0, (torch.where(real, jo, 0).clamp(min=0)
                               * K1)[None, :], VINF)
    last_row = torch.minimum(seg_q.clamp(max=S), tmax + half)
    last_row = torch.where(tmax < 0, 0, last_row).clamp(min=0)[:, None]
    best_s = torch.where(ok0 & (seg_q[:, None] >= 0),
                         jo[None, :] - 4 * (val >> 12),
                         torch.where(real, _NEG, _NEG - 1)[None, :])
    best_r = torch.zeros((B, Wp), dtype=torch.int32)
    best_v = val.clone()
    codes = torch.zeros((B, S, W), dtype=torch.int64)
    codes_flat = codes.view(B, S * W)
    q_rev = q_seg.flip(1)
    # a wide lane's border slots, [B, blocks, warps]: xh slice k's last
    # cell, xv its first; slice k is warp k % p of block k // p
    xh = val[:, SLICE_W - 1::SLICE_W].reshape(B, m_blocks, -1).clone()
    xv = None

    def slot(x, k):                                   # slice k's slot
        return x[:, k // p_warps, k % p_warps]

    # a cluster lane's block stages target bytes y0 .. y0 + ty - 1, y0 its
    # first cell; zeros past the window's S + W bytes (and, for the other
    # lanes, past the padding cells' reads)
    ty = S + SLICE_W * p_warps
    tpad_z = torch.cat([tpad, tpad.new_zeros((B, Wp + ty))], 1)
    for tau in range(2, 2 * S + W):
        # the cells of this step on rows 1..S (no other changes anything):
        # w = lo, lo + 2, ..., hi, on rows i_hi, i_hi - 1, ..., i_lo
        par = tau & 1
        lo = max(tau - 2 * S, par)
        hi = min(tau - 2, Wp - 2 + par)
        sl = slice(lo, hi + 1, 2)
        ws = torch.arange(lo, hi + 1, 2)
        i_hi, i_lo = (tau - lo) // 2, (tau - hi) // 2
        i = (tau - ws) // 2                           # the row of each cell
        in_range = (i[None, :] >= 1) & (i[None, :] <= last_row)
        # row i's query char q[i - 1]; target char tpad[i - 1 + w], one
        # further a cell
        qch = q_rev[:, S - i_hi:S - i_lo + 1]
        y_lo = i_hi - 1 + lo
        if cluster:
            # the block's window, clamped
            y = torch.arange(y_lo, y_lo + ws.numel())
            y0 = (ws // (SLICE_W * p_warps)) * (SLICE_W * p_warps)
            yc = y0 + (y - y0).clamp(0, ty - 1)
            assert not bool((in_range & ((yc != y) | (y >= S + W))[None, :]
                             & (ws < W)[None, :]).any())
            tch = tpad_z[:, yc]
        else:
            tch = tpad_z[:, y_lo:y_lo + ws.numel()]   # padding cells: any
        sub = (qch != tch).to(torch.int32)
        diag = val[:, sl] + sub * IND_K
        # cell w + 1 of row i - 1 and cell w - 1 of row i
        vert = valp[:, lo + 2:hi + 3:2] + K1
        hor = valp[:, lo:hi + 1:2] + K1
        if wide and par == 0:
            # a slice's first cell: the left warp's last, from its slot (the
            # block to the left's, at a block border)
            for w in range(-(-max(lo, 1) // SLICE_W) * SLICE_W, hi + 1,
                           SLICE_W):
                hor[:, (w - lo) // 2] = slot(xh, w // SLICE_W - 1) + K1
        elif wide:
            # a slice's last cell: the right warp's first, from its slot
            for w in range(-(-(lo + 1) // SLICE_W) * SLICE_W - 1,
                           min(hi, Wp - 2) + 1, SLICE_W):
                vert[:, (w - lo) // 2] = slot(xv, (w + 1) // SLICE_W) + K1
        j = (i + jo[sl]).to(torch.int32)[None, :]
        valid = (j >= 0) & (j <= tm)
        cur = torch.minimum(torch.minimum(diag, vert), hor)
        # iterations k = tau // 2 in [W - 1, min(tmax - W/2 + 1, last)] hold
        # valid cells only, and those are finite: the kernel drops the
        # validity select, the clamp and the VINF test there (not where the
        # band has padding)
        k = tau // 2
        fast = ((k >= W - 1) & (k <= torch.minimum(tm - half + 1, last_row))
                & (not padded))
        cur = torch.where(fast, cur,
                          torch.where(valid, cur.clamp(max=VINF), VINF))
        move = torch.where(cur == diag, sub,
                           torch.where(cur == vert, 2, 3)).long()
        val[:, sl] = torch.where(in_range, cur, val[:, sl])
        # the real cells' codes: codes[:, i - 1, w] lie W - 2 apart in the
        # flat [S * W] plane, the highest w first
        hr = hi if hi < W else W - 2 + par
        if hr >= lo:
            n_real = (hr - lo) // 2 + 1
            f_lo = ((tau - hr) // 2 - 1) * W + hr
            f_sl = slice(f_lo, f_lo + (n_real - 1) * (W - 2) + 1, W - 2)
            codes_flat[:, f_sl] = torch.where(
                in_range[:, :n_real], move[:, :n_real],
                codes_flat[:, f_sl].flip(1)).flip(1)
        score = i.to(torch.int32)[None, :] + j - 4 * (cur >> 12)
        better = (in_range & (fast | (cur < VINF))
                  & (score > best_s[:, sl]))
        best_s[:, sl] = torch.where(better, score, best_s[:, sl])
        best_r[:, sl] = torch.where(better, i.to(torch.int32)[None, :],
                                    best_r[:, sl])
        best_v[:, sl] = torch.where(better, cur, best_v[:, sl])
        if wide and par == 0:                         # the slots, published
            xv = val[:, ::SLICE_W].reshape(B, m_blocks, -1).clone()
        elif wide:
            xh = val[:, SLICE_W - 1::SLICE_W].reshape(B, m_blocks, -1).clone()
    flat = best_r * W + w_all[None, :]

    def reduce(s_, f_):                               # score desc, flat asc
        top = s_.max(dim=1, keepdim=True).values
        return top[:, 0], torch.where(s_ == top, f_, (S + 1) * W).min(
            dim=1).values

    if wide:
        # in each slice, then across the slices in order: over the blocks in
        # rank order, each block's slices in order
        s_red, f = reduce(best_s[:, :SLICE_W], flat[:, :SLICE_W])
        for c in range(m_blocks):
            for kb in range(p_warps):
                k = c * p_warps + kb
                if k == 0:
                    continue
                sl = slice(k * SLICE_W, (k + 1) * SLICE_W)
                s_k, f_k = reduce(best_s[:, sl], flat[:, sl])
                take = (s_k > s_red) | ((s_k == s_red) & (f_k < f))
                s_red = torch.where(take, s_k, s_red)
                f = torch.where(take, f_k, f)
    else:
        f = reduce(best_s, flat)[1]
    v = torch.gather(best_v, 1, (f % W).long()[:, None])[:, 0]
    r = torch.where(active, torch.div(f, W, rounding_mode="floor"), 0)
    w = torch.where(active, f % W, half)
    v = torch.where(active, v, VINF)
    best = _unpack_best(r.to(torch.int32), w.to(torch.int32), v, W)
    if not want_moves:
        return best
    packed = torch.zeros((B, S, W // 16), dtype=torch.int32)
    for b in range(B):
        if bool(active[b]):
            packed[b] = torch.as_tensor(move_rows_ring(
                codes[b].numpy(), int(last_row[b, 0]), S, W))
    return (packed, *best)


def valid_set(out, row0: int = 0) -> set:
    """The overlaps an OverlapStepOut keeps, as a set of (row, target,
    score, qbeg, qend, tbeg, tend) with rows counted from ``row0``."""
    f = {k: getattr(out, k).cpu().numpy()
         for k in ("valid", "target", "score", "qbeg", "qend", "tbeg",
                   "tend")}
    r, c = np.nonzero(f["valid"])
    return {(row0 + int(i), *(int(f[k][i, j]) for k in
                              ("target", "score", "qbeg", "qend", "tbeg",
                               "tend")))
            for i, j in zip(r, c)}


def m4_records(path: str) -> list:
    """Full M4 records of a file, sorted (an order-free comparison)."""
    from .io.m4 import read_m4

    return sorted((r.qid, r.sid, r.identity, r.score, r.qstrand, r.qstart,
                   r.qend, r.qsize, r.sstrand, r.sstart, r.send, r.ssize)
                  for r in read_m4(path))


def fasta_records(path: str) -> dict:
    """{name: bases} of a FASTA file (an order-free comparison)."""
    from .io.fasta import iter_fasta

    return {r.name: r.codes.tobytes() for r in iter_fasta(path)}


def _rank_task(task: str, rank: int, inputs: dict, out_dir: str,
               device) -> dict:
    """One task of :func:`rank_main`; returns what this rank reports."""
    from .parallel.cns_dist import run_cns_dist
    from .parallel.dist import make_grid
    from .pipeline.cns import CnsOptions
    from .pipeline.pw import PwOptions

    kind, *args = task.split("-")
    if kind == "collectives":       # the collectives the drivers use
        import torch.distributed as dist

        world = dist.get_world_size()
        for dt in (torch.int8, torch.int32, torch.int64):
            x = (rank * 10 + torch.arange(2 * world, device=device)).to(dt)
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)
            want = torch.cat([j * 10 + 2 * rank + torch.arange(2)
                              for j in range(world)]).to(dt)
            assert torch.equal(got.cpu(), want), (dt, got, want)
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            assert all(torch.equal(p.cpu(), (j * 10 + torch.arange(
                2 * world)).to(dt)) for j, p in enumerate(parts)), dt
        t = torch.tensor([rank], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        assert int(t.item()) == world - 1
        return {"backend": dist.get_backend(), "device": str(device)}
    if kind == "failon":            # failon-<rank>: one rank fails while
        import torch.distributed as dist   # the others wait on a barrier

        if rank == int(args[0]):
            raise RuntimeError(f"rank {rank} fails on purpose")
        dist.barrier()
        return {}
    if kind == "overlap":           # overlap-<n_data>x<n_hash>
        from .index.kmer_index import build_index
        from .parallel.sharded import index_shard, sharded_overlap_step

        n_data, n_hash = (int(x) for x in args[0].split("x"))
        grid = make_grid(n_data, n_hash)
        db, bases, lens, self_id = sharded_case()
        idx = build_index(db.codes, db.starts, db.lengths,
                          k=SHARDED_CFG["k"], device=device)
        Bl = len(bases) // n_data
        mine = slice(grid.d * Bl, (grid.d + 1) * Bl)
        out = sharded_overlap_step(
            *(torch.as_tensor(a[mine], device=device)
              for a in (bases, lens, self_id)),
            torch.as_tensor(db.codes, device=device),
            index_shard(idx, grid, device), idx.read_starts,
            idx.read_lengths, idx.max_occ_cutoff, grid, **SHARDED_CFG)
        Bh = Bl // n_hash
        return {"rows": Bh, "overlaps": sorted(valid_set(out, rank * Bh))}
    if kind == "pw":                # pw-<n_data>x<n_hash>
        from .parallel.dist import run_pw_dist

        n_data, n_hash = (int(x) for x in args[0].split("x"))
        stats = run_pw_dist(
            inputs["pw_reads"], os.path.join(out_dir, task + ".m4"),
            os.path.join(out_dir, "w" + task), PwOptions(**DIST_PW),
            n_data=n_data, n_hash=n_hash, device=device)
        return {k: getattr(stats, k) for k in ("candidates", "extended",
                                               "overlaps")}
    if kind == "cns":               # cns-r<rounds>[-c<cap bytes>]
        rounds = int(args[0][1:])
        cap = int(args[1][1:]) if len(args) > 1 else None
        stats = run_cns_dist(
            inputs["cns_cand"], inputs["cns_reads"],
            os.path.join(out_dir, task + ".fasta"),
            os.path.join(out_dir, "w" + task),
            CnsOptions(rounds=rounds, **inputs.get("cns_opts", PILE_CNS)),
            device=device, cap=cap)
        return {k: getattr(stats, k) for k in ("templates", "corrected_reads",
                                               "supports_aligned",
                                               "table_slices")}
    raise ValueError(f"unknown rank task {task!r}")


def rank_main(argv=None) -> int:
    """One rank of the multi-rank checks (``python -m
    mecat_tpu_torch.testing``): join the group, run every task in order
    and write ``<work>/out/<task>.r<rank>.json`` (what the rank reports,
    its seconds and its DP kernel launches).

    ``<work>/inputs.json`` names the inputs: ``pw_reads`` for ``pw-DxH``,
    ``cns_reads`` / ``cns_cand`` (and ``cns_opts``, default ``PILE_CNS``)
    for ``cns-rN[-cBYTES]``; ``overlap-DxH`` runs on :func:`sharded_case`.
    """
    import argparse
    import json
    import time

    import torch.distributed as dist

    from .ops import dp_kernel, walk_kernel
    from .parallel import sharded
    from .parallel.dist import init_distributed

    p = argparse.ArgumentParser(prog="mecat_tpu_torch.testing")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--device", default="cpu")
    p.add_argument("--work", required=True)
    p.add_argument("tasks", nargs="+")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    init_distributed(args.device, rank=args.rank, world_size=args.world,
                     init_method=args.init_method)
    device = torch.device(args.device)
    with open(os.path.join(args.work, "inputs.json")) as fh:
        inputs = json.load(fh)
    out_dir = os.path.join(args.work, "out")
    os.makedirs(out_dir, exist_ok=True)
    try:
        for task in args.tasks:
            l0 = (dp_kernel.LAUNCHES, dp_kernel.LAUNCHES_MOVES,
                  dp_kernel.LAUNCHES_EXTEND, dp_kernel.LAUNCHES_EXTEND_MOVES,
                  sharded.EXCHANGE_BYTES)
            walk0 = walk_kernel.launches()
            t0 = time.time()
            rec = _rank_task(task, args.rank, inputs, out_dir, device)
            rec.update(seconds=time.time() - t0,
                       launches=dp_kernel.LAUNCHES - l0[0],
                       launches_moves=dp_kernel.LAUNCHES_MOVES - l0[1],
                       launches_extend=dp_kernel.LAUNCHES_EXTEND - l0[2],
                       launches_extend_moves=(dp_kernel.LAUNCHES_EXTEND_MOVES
                                              - l0[3]),
                       exchange_bytes=sharded.EXCHANGE_BYTES - l0[4],
                       **walk_kernel.launches_since(walk0))
            with open(os.path.join(out_dir, f"{task}.r{args.rank}.json"),
                      "w") as fh:
                json.dump(rec, fh)
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(world: int, work: str, tasks, *, device: str = "cpu",
              timeout: float = 600.0) -> list:
    """Start ``world`` ranks of this module on ``tasks`` (all on
    ``device``) through ``parallel.dist.launch_ranks``; returns their logs
    or raises RuntimeError when one fails or the timeout passes."""
    from .parallel.dist import launch_ranks

    return launch_ranks("mecat_tpu_torch.testing", world, work,
                        ["--work", work, *tasks], devices=[device] * world,
                        timeout=timeout)


def rank_reports(work: str, tasks, world: int) -> dict:
    """{task: [what rank r reported, r = 0 .. world - 1]} of a
    :func:`run_ranks` run under ``work``."""
    import json

    out = {}
    for t in tasks:
        out[t] = []
        for r in range(world):
            with open(os.path.join(work, "out", f"{t}.r{r}.json")) as fh:
                out[t].append(json.load(fh))
    return out


if __name__ == "__main__":
    import sys

    sys.exit(rank_main())
