"""mecat2canu-equivalent assembly driver: a resumable staged pipeline (port
of ``mecat_tpu.assembly.driver``).

    gatekeeper -> meryl -> overlap(trim) -> trim -> overlap(asm) -> ovstore
    -> erate -> unitig -> consensus -> output

* every stage emits a durable on-disk artifact and a ``<stage>.done``
  marker; rerunning skips completed stages;
* the overlap stages reuse the device overlap pipeline
  (:func:`..pipeline.pw.run_pw`), and the consensus stage polishes on the
  device (:mod:`.ctgcns`); everything between them is host NumPy.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..index.meryl import kmer_histogram, pick_freq_cutoff
from ..io.fasta import write_fasta
from ..io.packed_db import PackedDB
from ..ops import dp_kernel, walk_kernel
from ..pipeline.pw import PwOptions, run_pw
from ..pipeline.trim import TrimOptions, run_trim
from ..utils.log import get_logger
from ..utils.metrics import Metrics
from .ctgcns import CtgCnsOptions, PolishStats, contig_consensus
from .erate import estimate_read_erates
from .ovstore import OverlapStore
from .unitig import arrays_to_layouts, build_unitigs, layouts_to_arrays

log = get_logger("canu")


@dataclass
class AsmOptions:
    """mecat2canu-style options (the key=value surface of its CLI)."""

    genome_size: int = 0            # genomeSize= (0 = unknown; stats only)
    error_rate: float = 0.02        # ErrorRate= (corrected reads)
    adjust_erates: bool = True      # overlapErrorAdjustment stage on/off
    max_adj_erate: Optional[float] = None   # residual-erate overlap filter;
    # default = max(0.05, 2.5 * error_rate): generous vs the residual noise
    # floor (binomial sigma ~ 0.003 at 5 kb span) so only repeat-induced
    # overlaps, whose divergence per-read error cannot explain, are dropped
    do_trim: bool = True            # -trim-assemble
    min_read_length: int = 1000
    min_overlap_length: int = 500
    min_contig_length: int = 1000
    end_slack: int = 100
    pw: Optional[PwOptions] = None
    trim: Optional[TrimOptions] = None
    cns: Optional[CtgCnsOptions] = None


@dataclass
class AsmReport:
    stages: List[str] = field(default_factory=list)
    n_reads: int = 0
    n_overlaps: int = 0
    n_unitigs: int = 0
    n_contigs: int = 0
    total_contig_bases: int = 0
    max_contig: int = 0
    n50: int = 0
    seconds: float = 0.0


def _n50(lengths: List[int]) -> int:
    if not lengths:
        return 0
    s = sorted(lengths, reverse=True)
    total = sum(s)
    acc = 0
    for x in s:
        acc += x
        if acc * 2 >= total:
            return x
    return s[-1]


class Stage:
    """Durable-artifact stage with a .done marker (the resume contract).
    With ``met`` a finished stage records its seconds there."""

    def __init__(self, wrk: str, name: str, report: AsmReport,
                 met: Optional[Metrics] = None):
        self.marker = os.path.join(wrk, name + ".done")
        self.name = name
        self.report = report
        self.met = met
        self.t0 = time.time()

    @property
    def done(self) -> bool:
        return os.path.exists(self.marker)

    def finish(self, **meta):
        with open(self.marker, "w") as fh:
            json.dump({"stage": self.name, "t": time.time(), **meta}, fh)
        self.report.stages.append(self.name)
        if self.met is not None:
            self.met.set(f"{self.name}_seconds", time.time() - self.t0)
        log.info("canu: stage %s done %s", self.name, meta or "")


def run_assembly(reads_path: str, prefix: str, wrk_dir: str,
                 opts: Optional[AsmOptions] = None, *, device) -> AsmReport:
    """Full assembly of (corrected) reads -> <wrk>/<prefix>.contigs.fasta,
    the overlap and consensus stages on ``device``."""
    opts = opts or AsmOptions()
    os.makedirs(wrk_dir, exist_ok=True)
    t0 = time.time()
    report = AsmReport()
    met = Metrics("canu")
    dp0 = dp_kernel.launches()
    walk0 = walk_kernel.launches()

    def path(p):
        return os.path.join(wrk_dir, p)

    # -- gatekeeper: reads -> gkStore-equivalent packed DB ---------------------
    st = Stage(wrk_dir, "gatekeeper", report, met)
    gk_prefix = path(prefix + ".gk")
    if not st.done:
        db = PackedDB.from_fasta(reads_path)
        keep = [i for i in range(db.n_reads)
                if int(db.lengths[i]) >= opts.min_read_length]
        db = db.subset(keep)
        db.save(gk_prefix)
        st.finish(n_reads=db.n_reads, n_bases=db.total_bases)
    db = PackedDB.load(gk_prefix)
    report.n_reads = db.n_reads
    if db.n_reads == 0:
        report.seconds = time.time() - t0
        return report

    # -- meryl: k-mer spectrum -> overlap-seeding frequency cutoff -------------
    # The spectrum is computed at the OVERLAPPER's k so the derived cutoff is
    # directly an occurrence bound for the pw index; both overlap rounds
    # (trim + assembly) consume it as PwOptions.index_cutoff.
    pw_opts = opts.pw or PwOptions(task=1,
                                   min_align_size=opts.min_overlap_length)
    st = Stage(wrk_dir, "meryl", report, met)
    meryl_path = path(prefix + ".meryl.npz")
    if not st.done:
        hist = kmer_histogram(db, k=pw_opts.kmer_size)
        cutoff = pick_freq_cutoff(hist)
        np.savez(meryl_path, hist=hist, cutoff=np.int64(cutoff),
                 k=np.int64(pw_opts.kmer_size))
        st.finish(k=pw_opts.kmer_size, cutoff=int(cutoff))
    meryl = np.load(meryl_path)
    if pw_opts.index_cutoff is None:
        pw_opts.index_cutoff = int(meryl["cutoff"])
    log.info("canu: meryl k=%d seeding cutoff=%d", int(meryl["k"]),
             pw_opts.index_cutoff)

    # -- trim round: overlap + overlap-based trimming -------------------------
    asm_reads = reads_path
    asm_db: Optional[PackedDB] = db
    if opts.do_trim:
        st = Stage(wrk_dir, "trim", report, met)
        trimmed = path(prefix + ".trimmedReads.fasta")
        if not st.done:
            trim_opts = opts.trim or TrimOptions(
                min_trimmed_length=opts.min_read_length,
                pw=pw_opts)
            tstats = run_trim_from_db(db, trimmed, path("trim_wrk"),
                                      trim_opts, device=device)
            st.finish(reads_out=tstats.reads_out, bases_out=tstats.bases_out)
        asm_reads = trimmed
        asm_db = None  # reload below

    if asm_db is None:
        asm_db = PackedDB.from_fasta(asm_reads)
    if asm_db.n_reads == 0:
        report.seconds = time.time() - t0
        return report

    # -- assembly overlaps (mecat2asmpw role) ----------------------------------
    st = Stage(wrk_dir, "overlap", report, met)
    asm_m4 = path(prefix + ".asm.m4")
    if not st.done:
        stats = run_pw(asm_reads, asm_m4, path("asm_pw"), pw_opts, db=asm_db,
                       device=device)
        st.finish(overlaps=stats.overlaps)

    # -- ovStore ---------------------------------------------------------------
    st = Stage(wrk_dir, "ovstore", report, met)
    ovs_prefix = path(prefix)
    if not st.done:
        store = OverlapStore.from_m4(asm_m4, asm_db.n_reads)
        store.save(ovs_prefix)
        st.finish(n_overlaps=len(store))
    store = OverlapStore.load(ovs_prefix)
    report.n_overlaps = len(store)

    # -- overlap error adjustment ------------------------------------------------
    # (overlapErrorAdjustment role): estimate per-read
    # error rates from the overlap pile, hand the unitigger residual-adjusted
    # identities so edge ranking/filtering is insensitive to per-read noise.
    adj_ident = None
    min_ident = 0.0
    if opts.adjust_erates and len(store) > 0:
        st = Stage(wrk_dir, "erate", report, met)
        er_path = path(prefix + ".erate.npz")
        max_resid = (opts.max_adj_erate if opts.max_adj_erate is not None
                     else max(0.05, 2.5 * opts.error_rate))
        if not st.done:
            res = estimate_read_erates(store)
            np.savez(er_path, e=res.e, adj_identity=res.adj_identity,
                     residual=res.residual)
            st.finish(mean_erate=round(float(res.e.mean()), 5),
                      max_resid=max_resid,
                      dropped=int((res.residual > max_resid).sum()))
        er = np.load(er_path)
        adj_ident = er["adj_identity"]
        min_ident = 100.0 * (1.0 - max_resid)
        log.info("canu: erate mean=%.4f filter=adjusted identity >= %.2f",
                 float(er["e"].mean()), min_ident)

    # -- unitig (bogart role) ---------------------------------------------------
    st = Stage(wrk_dir, "unitig", report, met)
    layout_path = path(prefix + ".layout.npz")
    if not st.done:
        bog = build_unitigs(store, end_slack=opts.end_slack,
                            min_identity=min_ident, identity=adj_ident)
        np.savez(layout_path, **layouts_to_arrays(bog.unitigs))
        st.finish(n_unitigs=len(bog.unitigs),
                  n_contained=int(bog.contained.sum()),
                  n_dovetail=bog.n_dovetail)
    tigs = arrays_to_layouts(np.load(layout_path))
    report.n_unitigs = len(tigs)

    # -- consensus (utgcns role) -------------------------------------------------
    st = Stage(wrk_dir, "consensus", report, met)
    contigs_path = path(prefix + ".contigs.fasta")
    if not st.done:
        polish = PolishStats()
        recs = contig_consensus(asm_db, tigs, opts.cns,
                                min_length=opts.min_contig_length,
                                device=device, stats=polish)
        write_fasta(contigs_path, recs)
        st.finish(n_contigs=len(recs), **polish.__dict__)
        for k, v in polish.__dict__.items():
            met.set(f"polish_{k}", v)

    # -- output: report + layout text + GFA --------------------------------------
    st = Stage(wrk_dir, "output", report, met)
    lens = [int(db2l) for db2l in
            PackedDB.from_fasta(contigs_path).lengths] \
        if os.path.exists(contigs_path) else []
    report.n_contigs = len(lens)
    report.total_contig_bases = int(sum(lens))
    report.max_contig = max(lens) if lens else 0
    report.n50 = _n50(lens)
    if not st.done:
        _write_layout_text(path(prefix + ".layout.txt"), tigs, asm_db)
        _write_gfa(path(prefix + ".contigs.gfa"), contigs_path)
        with open(path(prefix + ".report"), "w") as fh:
            json.dump(report.__dict__, fh, indent=1)
        st.finish(n_contigs=report.n_contigs, n50=report.n50)
    report.seconds = time.time() - t0
    for name in ("n_reads", "n_overlaps", "n_unitigs", "n_contigs",
                 "total_contig_bases", "max_contig", "n50"):
        met.set(name, getattr(report, name))
    met.set("stages_run", len(report.stages))
    met.set("seconds", round(report.seconds, 3))
    for name, n in dp_kernel.launches_since(dp0).items():
        met.set(name, n)
    for name, n in walk_kernel.launches_since(walk0).items():
        met.set(name, n)
    if torch.device(device).type == "cuda":
        met.set("peak_device_gb",
                round(torch.cuda.max_memory_allocated(device) / 1e9, 3))
    met.emit_summary()
    return report


def run_trim_from_db(db: PackedDB, out_path: str, wrk: str,
                     opts: TrimOptions, *, device):
    """run_trim over an in-memory DB (writes a FASTA for the stage artifact)."""
    os.makedirs(wrk, exist_ok=True)
    reads_fa = os.path.join(wrk, "reads_in.fasta")
    if not os.path.exists(reads_fa):
        write_fasta(reads_fa, [(db.name(i), db.read(i))
                               for i in range(db.n_reads)])
    return run_trim(reads_fa, out_path, wrk, opts, device=device)


def _write_layout_text(path: str, tigs, db: PackedDB) -> None:
    """Human-readable layouts (canu 'layout' dump role)."""
    with open(path, "w") as fh:
        for i, tig in enumerate(tigs):
            fh.write(f"tig {i} reads {len(tig.rows)}"
                     f"{' circular' if tig.circular else ''}\n")
            for r in sorted(tig.rows, key=lambda r: (r.offset, r.read)):
                fh.write(f"  read {db.name(r.read)} orient "
                         f"{'-' if r.orient else '+'} offset {r.offset}"
                         f"{' contained' if r.contained else ''}\n")


def _write_gfa(path: str, contigs_fasta: str) -> None:
    """Minimal GFA1 (S lines) of the final contigs."""
    from ..io.fasta import decode_bases
    if not os.path.exists(contigs_fasta):
        return
    db = PackedDB.from_fasta(contigs_fasta)
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for i in range(db.n_reads):
            fh.write(f"S\t{db.name(i)}\t"
                     f"{decode_bases(db.read(i)).decode()}\tLN:i:"
                     f"{int(db.lengths[i])}\n")
