"""SAM output of mecat2ref (NumPy; copy of ``mecat_tpu.io.sam``).

SAM v1.6 subset: @HD/@SQ/@PG header, one alignment line per mapped read
(FLAG 0/16, 1-based POS, CIGAR with soft clips, SEQ in alignment
orientation), FLAG 4 for unmapped reads.  The @PG line names the program as
the JAX package does, so the two packages' SAM files compare byte for byte.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import __version__
from .fasta import decode_bases


def sam_header(contigs: Sequence[Tuple[str, int]]) -> str:
    lines = ["@HD\tVN:1.6\tSO:unknown"]
    for name, length in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    lines.append(f"@PG\tID:mecat_tpu\tPN:mecat2ref\tVN:{__version__}")
    return "\n".join(lines) + "\n"


def cigar_from_ops(ops: np.ndarray, qbeg: int, qend: int, qsize: int,
                   match_codes=(0, 1), ins_code=2, del_code=3) -> str:
    """Run-length encode forward-ordered move codes into a CIGAR string.

    ops: int array of move codes (ops/align MOVE_*); soft clips are added
    for the unaligned query prefix and suffix (coordinates in alignment
    orientation).
    """
    out: List[str] = []
    if qbeg > 0:
        out.append(f"{qbeg}S")
    if len(ops):
        sym = np.where(np.isin(ops, match_codes), 0,
                       np.where(ops == ins_code, 1, 2))
        change = np.nonzero(np.diff(sym))[0] + 1
        bounds = np.concatenate([[0], change, [len(sym)]])
        letters = "MID"
        for a, b in zip(bounds[:-1], bounds[1:]):
            out.append(f"{b - a}{letters[sym[a]]}")
    tail = qsize - qend
    if tail > 0:
        out.append(f"{tail}S")
    return "".join(out) if out else "*"


def sam_line(qname: str, flag: int, rname: str, pos0: int, mapq: int,
             cigar: str, seq_codes: np.ndarray, tags: str = "") -> str:
    seq = decode_bases(seq_codes).decode() if len(seq_codes) else "*"
    base = (f"{qname}\t{flag}\t{rname}\t{pos0 + 1}\t{mapq}\t{cigar}\t"
            f"*\t0\t0\t{seq}\t*")
    return base + ("\t" + tags if tags else "")


def sam_unmapped(qname: str, seq_codes: np.ndarray) -> str:
    seq = decode_bases(seq_codes).decode() if len(seq_codes) else "*"
    return f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t*"
