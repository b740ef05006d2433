"""mecat2pw CLI on PyTorch — the flags of mecat_tpu.cli.mecat2pw plus --device.

Usage:
    python -m mecat_tpu_torch.cli.mecat2pw -j 0 -d reads.fasta -o cand.txt \
        -w wrk [-n 100] [-a 2000] [-k 32] [-g 0] [--device cuda] \
        [--route staged|fused]

``-t`` (threads) is accepted for compatibility; parallelism is device
batching.  ``--device`` names the torch device (default ``cuda``); the tool
refuses to start if that device does not exist.  ``--route`` picks the
``-j 1`` route of ``pipeline.pw.run_pw``: ``fused`` probes every candidate
on the device and extends the survivors, top n per strand; ``staged``
extends the pairs left by the host's strand merge.  Without it the route is
``pipeline.pw.default_route``: fused for ``-j 1`` on ``cuda``, staged
otherwise.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .. import constants as C
from ..pipeline.pw import ROUTES, PwOptions, run_pw
from ..utils.log import get_logger

log = get_logger("cli.pw")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mecat2pw", description="pairwise overlap detection (PyTorch)")
    p.add_argument("-j", dest="task", type=int, default=0, choices=(0, 1),
                   help="task: 0 = detect candidates only, 1 = full M4 overlaps")
    p.add_argument("-d", dest="reads", required=True, help="input reads FASTA/FASTQ")
    p.add_argument("-o", dest="output", required=True, help="output file")
    p.add_argument("-w", dest="wrk_dir", required=True, help="working directory")
    p.add_argument("-t", dest="threads", type=int, default=1,
                   help="accepted for compatibility (device-batched instead)")
    p.add_argument("-n", dest="num_candidates", type=int,
                   default=C.DEFAULT_NUM_CANDIDATES,
                   help="number of candidates per read")
    p.add_argument("-a", dest="min_align_size", type=int,
                   default=C.DEFAULT_MIN_ALIGN_SIZE,
                   help="minimum alignment size to report")
    p.add_argument("-k", dest="max_occ", type=int, default=C.MAX_OCC_PER_KMER,
                   help="max k-mer occurrences gathered per probe")
    p.add_argument("-g", dest="print_ext", type=int, default=0, choices=(0, 1),
                   help="1 = append gapped-extension seed point columns")
    p.add_argument("--kmer-size", type=int, default=C.KMER_SIZE)
    p.add_argument("--scan-stride", type=int, default=C.KMER_SCAN_STRIDE)
    p.add_argument("--min-identity", type=float, default=C.MIN_OVERLAP_IDENTITY)
    p.add_argument("--volume-bases", type=int, default=C.DEFAULT_VOLUME_BASES)
    p.add_argument("--scan-batch", type=int, default=C.DEFAULT_SCAN_BATCH)
    p.add_argument("--extend-batch", type=int, default=C.DEFAULT_EXTEND_BATCH)
    p.add_argument("--align-segment", type=int, default=C.ALIGN_SEGMENT)
    p.add_argument("--align-band", type=int, default=C.ALIGN_BAND)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--route", default=None, choices=ROUTES,
                   help="-j 1 route: staged (host-built extension batches) "
                        "or fused (device probe, survivors extended); "
                        "default fused for -j 1 on cuda, else staged")
    return p


def device_exists(name: str) -> bool:
    """Whether the torch device ``name`` exists on this machine."""
    try:
        dev = torch.device(name)
    except RuntimeError:
        return False
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return (torch.cuda.is_available()
                and (dev.index or 0) < torch.cuda.device_count())
    return False


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not device_exists(args.device):
        parser.error(f"device {args.device!r} does not exist on this machine")
    if args.route == "fused" and args.task != 1:
        parser.error("--route fused computes -j 1 only")
    opts = PwOptions(
        task=args.task, num_candidates=args.num_candidates,
        min_align_size=args.min_align_size, min_identity=args.min_identity,
        kmer_size=args.kmer_size, scan_stride=args.scan_stride,
        max_occ=args.max_occ, volume_bases=args.volume_bases,
        scan_batch=args.scan_batch, extend_batch=args.extend_batch,
        align_segment=args.align_segment, align_band=args.align_band,
        print_ext=args.print_ext)
    stats = run_pw(args.reads, args.output, args.wrk_dir, opts,
                   device=args.device, route=args.route)
    log.info("done: %d reads, %d candidates, %d overlaps in %.1fs",
             stats.reads, stats.candidates, stats.overlaps, stats.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
