"""mecat2cns CLI on PyTorch: the flags of mecat_tpu.cli.mecat2cns plus --device.

Usage:
    python -m mecat_tpu_torch.cli.mecat2cns -i 0 [-x 0|1] [-p batch]
        [-r ratio] [-a ovlsize] [-c cov] [-l minlen] [--device cuda]
        input reads output

``-t`` (threads) is accepted for compatibility; parallelism is device
batching.  ``--device`` names the torch device (default ``cuda``); the tool
refuses to start if that device does not exist.  Flags left unset take the
``-x`` technology preset: with ``-x 0`` corrected segments under 5000 bases
are dropped and alignments under 2000 bases filtered, so short reads need
``-l`` and ``-a``.  Only ``--rounds 1`` is ported; any other value exits
with code 2.
"""
from __future__ import annotations

import argparse
import sys

from .. import constants as C
from ..pipeline.cns import CnsOptions, run_cns
from ..utils.log import get_logger
from .mecat2pw import device_exists

log = get_logger("cli.cns")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mecat2cns", description="consensus error correction (PyTorch)")
    p.add_argument("-i", dest="input_type", type=int, default=0,
                   choices=(0, 1), help="input type: 0 candidates, 1 M4")
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="accepted for compatibility (device-batched instead)")
    p.add_argument("-x", dest="tech", type=int, default=C.TECH_PACBIO,
                   choices=(0, 1), help="technology: 0 pacbio, 1 nanopore")
    p.add_argument("-p", dest="partition_size", type=int,
                   default=C.DEFAULT_PARTITION_BATCH,
                   help="templates per partition batch")
    # None => the per-technology preset for -x decides
    p.add_argument("-r", dest="min_mapping_ratio", type=float, default=None)
    p.add_argument("-a", dest="min_align_size", type=int, default=None)
    p.add_argument("-c", dest="min_coverage", type=int, default=None)
    p.add_argument("-l", dest="min_length", type=int, default=None)
    p.add_argument("--align-segment", type=int, default=C.ALIGN_SEGMENT)
    p.add_argument("--align-band", type=int, default=C.ALIGN_BAND)
    p.add_argument("--extend-batch", type=int, default=128)
    p.add_argument("--max-est-coverage", type=int, default=None,
                   help="stop recruiting supports once their summed extents "
                        "reach this many template lengths (0 disables)")
    p.add_argument("--rounds", type=int, default=1,
                   help="correction rounds; only 1 is ported")
    p.add_argument("--draft-est-coverage", type=int, default=None,
                   help="est-coverage cap for non-final rounds (accepted; "
                        "unused while only one round is ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("input", help="candidates/M4 file from mecat2pw")
    p.add_argument("reads", help="raw reads FASTA/FASTQ")
    p.add_argument("output", help="corrected reads FASTA")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.rounds != 1:
        parser.error(f"--rounds {args.rounds} is not ported yet: only a "
                     "single correction round runs on PyTorch")
    if not device_exists(args.device):
        parser.error(f"device {args.device!r} does not exist on this machine")
    opts = CnsOptions.for_tech(
        args.tech,
        input_type=args.input_type,
        partition_size=args.partition_size,
        min_mapping_ratio=args.min_mapping_ratio,
        min_align_size=args.min_align_size, min_coverage=args.min_coverage,
        min_length=args.min_length, align_segment=args.align_segment,
        align_band=args.align_band, extend_batch=args.extend_batch,
        max_est_coverage=args.max_est_coverage)
    stats = run_cns(args.input, args.reads, args.output, opts,
                    device=args.device)
    log.info("done: %d templates, %d supports aligned, %d corrected reads "
             "(%d bases) in %.1fs", stats.templates, stats.supports_aligned,
             stats.corrected_reads, stats.corrected_bases, stats.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
