"""mecat_pipeline CLI: the full correct+trim pipeline in one command (port
of ``mecat_tpu.cli.pipeline`` plus ``--device``).

    python -m mecat_tpu_torch.cli.pipeline -d reads.fasta -o out_dir
        -g genome_size [--rounds N] [--device cuda]

Drives the multi-tool flow end to end on one host.  Each stage emits a
durable artifact and is skipped when its output already exists:

  1. mecat2pw -j 0      raw reads -> candidates.txt
  2. mecat2cns          candidates + raw reads -> corrected.fasta
  3. extract_sequences  corrected -> extracted.fasta (genome_size x coverage)
  4. mecat2pw -j 1      extracted -> asm_overlaps.m4 (assembly-grade
                        overlaps of corrected reads)
  5. trim               extracted + asm_overlaps -> trimmed.fasta

Stages 1, 2 and 4 run on ``--device`` (default ``cuda``; the tool refuses to
start, exit code 2, where that device is missing).
"""
from __future__ import annotations

import argparse
import os
import sys

from .. import constants as C
from ..pipeline.cns import CnsOptions, run_cns
from ..pipeline.pw import PwOptions, run_pw
from ..pipeline.trim import TrimOptions, run_trim
from ..utils.log import get_logger
from ..utils.metrics import Metrics
from .extract_sequences import extract
from .mecat2pw import device_exists

log = get_logger("cli.pipeline")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mecat_pipeline",
        description="correct+trim pipeline (PyTorch)")
    p.add_argument("-d", dest="reads", required=True)
    p.add_argument("-o", dest="out_dir", required=True)
    p.add_argument("-x", dest="tech", type=int, default=C.TECH_PACBIO,
                   choices=(0, 1))
    p.add_argument("-g", dest="genome_size", type=int, required=True)
    p.add_argument("-c", dest="coverage", type=float, default=25.0,
                   help="target corrected coverage for extract_sequences")
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-n", dest="num_candidates", type=int,
                   default=C.DEFAULT_NUM_CANDIDATES)
    p.add_argument("-a", dest="min_align_size", type=int,
                   default=C.DEFAULT_MIN_ALIGN_SIZE)
    # None => the per-technology preset for -x decides
    p.add_argument("--min-coverage", type=int, default=None)
    p.add_argument("--min-length", type=int, default=None)
    p.add_argument("--kmer-size", type=int, default=C.KMER_SIZE)
    p.add_argument("--scan-stride", type=int, default=C.KMER_SCAN_STRIDE)
    p.add_argument("--scan-batch", type=int, default=C.DEFAULT_SCAN_BATCH)
    p.add_argument("--extend-batch", type=int, default=C.DEFAULT_EXTEND_BATCH)
    p.add_argument("--align-segment", type=int, default=C.ALIGN_SEGMENT)
    p.add_argument("--align-band", type=int, default=C.ALIGN_BAND)
    p.add_argument("--diag-bin", type=int, default=C.DDF_DIAG_BIN)
    p.add_argument("--rounds", type=int, default=1,
                   help="cns correction rounds (2 = realign vs draft)")
    p.add_argument("--draft-est-coverage", type=int, default=None,
                   help="est-coverage cap for non-final cns rounds")
    p.add_argument("--resume", action="store_true", default=True,
                   help="skip stages whose output artifact already exists")
    p.add_argument("--no-resume", dest="resume", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not device_exists(args.device):
        parser.error(f"device {args.device!r} does not exist on this machine")
    preset = C.CNS_TECH_PRESETS[args.tech]
    if args.min_length is None:
        args.min_length = preset["min_length"]
    if args.min_coverage is None:
        args.min_coverage = preset["min_coverage"]
    os.makedirs(args.out_dir, exist_ok=True)
    pw_kwargs = dict(
        num_candidates=args.num_candidates,
        min_align_size=args.min_align_size, kmer_size=args.kmer_size,
        scan_stride=args.scan_stride, scan_batch=args.scan_batch,
        extend_batch=args.extend_batch, align_segment=args.align_segment,
        align_band=args.align_band, diag_bin=args.diag_bin)

    met = Metrics("pipeline")
    ran = []

    def artifact(name):
        return os.path.join(args.out_dir, name)

    def stage(name, output, fn):
        if args.resume and os.path.exists(output):
            log.info("pipeline: %s exists, skipping %s", output, name)
            return
        log.info("pipeline: stage %s -> %s", name, output)
        with met.stage(name):
            fn()
        assert os.path.exists(output), f"stage {name} produced no {output}"
        ran.append(name)

    candidates = artifact("candidates.txt")
    corrected = artifact("corrected.fasta")
    extracted = artifact("extracted.fasta")
    asm_ovl = artifact("asm_overlaps.m4")
    trimmed = artifact("trimmed.fasta")

    stage("pw-candidates", candidates, lambda: run_pw(
        args.reads, candidates, artifact("wrk_pw"),
        PwOptions(task=0, **pw_kwargs), device=args.device))
    stage("cns", corrected, lambda: run_cns(
        candidates, args.reads, corrected,
        CnsOptions.for_tech(
            args.tech, input_type=0,
            min_coverage=args.min_coverage,
            min_length=args.min_length,
            align_segment=args.align_segment,
            align_band=args.align_band,
            extend_batch=args.extend_batch,
            draft_est_coverage=args.draft_est_coverage,
            rounds=args.rounds), device=args.device))
    stage("extract", extracted,
          lambda: _extract_to(corrected, extracted, args))
    stage("asm-overlaps", asm_ovl, lambda: run_pw(
        extracted, asm_ovl, artifact("wrk_asm"),
        PwOptions(task=1, min_identity=85.0, **pw_kwargs),
        device=args.device))
    stage("trim", trimmed, lambda: run_trim(
        extracted, trimmed, artifact("wrk_trim"),
        TrimOptions(min_trimmed_length=args.min_length),
        overlaps_path=asm_ovl, device=args.device))
    log.info("pipeline: done: %s, %s", trimmed, asm_ovl)
    met.set("stages_run", len(ran))
    met.emit_summary()
    return 0


def _extract_to(corrected, extracted, args):
    prefix = extracted[:-6] if extracted.endswith(".fasta") else extracted
    extract(corrected, prefix, args.genome_size, args.coverage)
    if prefix + ".fasta" != extracted:
        os.replace(prefix + ".fasta", extracted)


if __name__ == "__main__":
    sys.exit(main())
