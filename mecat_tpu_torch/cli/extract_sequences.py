"""extract_sequences CLI: pick the longest corrected reads to a target
coverage (copy of ``mecat_tpu.cli.extract_sequences`` plus ``--device``).

    python -m mecat_tpu_torch.cli.extract_sequences corrected.fasta
        output_prefix <genome_size> <coverage> [--device cuda]

Selects reads longest-first until genome_size * coverage bases are collected
and writes them, in input order, to ``<output_prefix>.fasta``.  The
selection is host work; ``--device`` is taken as by every tool of the port
(default ``cuda``, refused with exit code 2 where that device is missing).
"""
from __future__ import annotations

import argparse
import sys

from ..io.fasta import iter_fasta, write_fasta
from ..utils.log import get_logger
from .mecat2pw import device_exists

log = get_logger("cli.extract")


def extract(input_path: str, output_prefix: str, genome_size: int,
            coverage: float) -> int:
    records = [(rec.name, rec.codes) for rec in iter_fasta(input_path)]
    target = int(genome_size * coverage)
    order = sorted(range(len(records)), key=lambda i: -len(records[i][1]))
    picked, total = [], 0
    for i in order:
        if total >= target:
            break
        picked.append(i)
        total += len(records[i][1])
    picked.sort()  # keep input order among the selected reads
    write_fasta(output_prefix + ".fasta", [records[i] for i in picked])
    log.info("extract: %d/%d reads, %d bases (target %d)", len(picked),
             len(records), total, target)
    return len(picked)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="extract_sequences")
    p.add_argument("input", help="corrected reads FASTA")
    p.add_argument("output", help="output prefix")
    p.add_argument("genome_size", type=int)
    p.add_argument("coverage", type=float)
    p.add_argument("--device", default="cuda",
                   help="torch device of the port's tools (cuda, cuda:N or "
                        "cpu); nothing of this tool runs on it")
    args = p.parse_args(argv)
    if not device_exists(args.device):
        p.error(f"device {args.device!r} does not exist on this machine")
    extract(args.input, args.output, args.genome_size, args.coverage)
    return 0


if __name__ == "__main__":
    sys.exit(main())
