"""mecat2canu CLI: assembly of corrected reads (port of
``mecat_tpu.cli.mecat2canu`` plus ``--device``).

    python -m mecat_tpu_torch.cli.mecat2canu -trim-assemble -p prefix -d dir
        genomeSize=4.8m ErrorRate=0.02 -pacbio-corrected reads.fa
        [--device cuda]

Canu-style ``key=value`` options are accepted positionally.  maxMemory /
maxThreads / useGrid are accepted for compatibility: parallelism here is
device batching, not a grid scheduler.  ``--device`` names the torch device
(default ``cuda``); the tool refuses to start, exit code 2, where that
device is missing.
"""
from __future__ import annotations

import argparse
import sys

from ..assembly.driver import AsmOptions, run_assembly
from ..utils.log import get_logger
from .mecat2pw import device_exists

log = get_logger("cli.canu")


def parse_size(v: str) -> int:
    v = v.strip().lower()
    mult = 1
    if v and v[-1] in "kmg":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[v[-1]]
        v = v[:-1]
    return int(float(v) * mult)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mecat2canu",
        description="assembly of corrected reads (PyTorch OLC)")
    p.add_argument("-p", dest="prefix", required=True, help="output prefix")
    p.add_argument("-d", dest="dir", required=True, help="working directory")
    p.add_argument("-trim-assemble", dest="trim_assemble",
                   action="store_true", help="trim then assemble")
    p.add_argument("-assemble", dest="assemble", action="store_true",
                   help="assemble without trimming")
    p.add_argument("-pacbio-corrected", dest="reads", default=None,
                   help="corrected PacBio reads FASTA")
    p.add_argument("-nanopore-corrected", dest="reads_ont", default=None,
                   help="corrected Nanopore reads FASTA")
    p.add_argument("kv", nargs="*",
                   help="canu key=value options (genomeSize=, ErrorRate=, "
                        "maxMemory=, maxThreads=, useGrid= accepted)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not device_exists(args.device):
        parser.error(f"device {args.device!r} does not exist on this machine")
    reads = args.reads or args.reads_ont
    if reads is None:
        print("mecat2canu: need -pacbio-corrected or -nanopore-corrected",
              file=sys.stderr)
        return 2
    kv = {}
    for item in args.kv:
        if "=" not in item:
            print(f"mecat2canu: bad option {item!r} (expected key=value)",
                  file=sys.stderr)
            return 2
        k, v = item.split("=", 1)
        kv[k.lower()] = v
    opts = AsmOptions(
        genome_size=parse_size(kv.get("genomesize", "0")),
        error_rate=float(kv.get("errorrate", "0.02")),
        do_trim=args.trim_assemble or not args.assemble,
        min_read_length=int(kv.get("minreadlength", "1000")),
        min_overlap_length=int(kv.get("minoverlaplength", "500")),
    )
    report = run_assembly(reads, args.prefix, args.dir, opts,
                          device=args.device)
    log.info("done: %d reads -> %d contigs (N50 %d, max %d, %d bases) "
             "in %.1fs", report.n_reads, report.n_contigs, report.n50,
             report.max_contig, report.total_contig_bases, report.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
