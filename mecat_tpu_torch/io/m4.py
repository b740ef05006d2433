"""M4 overlap records and candidate records as text.

Copy of the writers and parsers of ``mecat_tpu.io.m4`` without its native
C++ fast path: the bytes and the parsed records are the same.  M4 line
layout::

    qid sid identity score qstrand qstart qend qsize sstrand sstart send ssize

with 1-based read ids, the query on its forward strand (qstrand 0), 0-based
half-open coordinates on each read's forward strand and identity as %.2f.
``-g 1`` appends the seed columns qext, sext.  Candidate lines are
``qid sid score qdir qext qsize sdir sext ssize``: qext is the seed position
in the qdir-oriented query, sext the seed position on the forward subject.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from ..constants import M4_IDENTITY_DECIMALS


@dataclass
class M4Record:
    qid: int          # 1-based
    sid: int          # 1-based
    identity: float   # percent
    score: int        # DDF block score
    qstrand: int      # always 0 (query normalised to forward)
    qstart: int
    qend: int
    qsize: int
    sstrand: int      # 0/1
    sstart: int
    send: int
    ssize: int
    qext: int | None = None   # -g 1 seed columns; None = 12-column M4
    sext: int | None = None

    def format(self) -> str:
        base = (f"{self.qid}\t{self.sid}\t"
                f"{self.identity:.{M4_IDENTITY_DECIMALS}f}\t{self.score}\t"
                f"{self.qstrand}\t{self.qstart}\t{self.qend}\t{self.qsize}\t"
                f"{self.sstrand}\t{self.sstart}\t{self.send}\t{self.ssize}")
        if self.qext is not None:
            base += f"\t{self.qext}\t{self.sext}"
        return base

    @classmethod
    def parse(cls, line: str) -> "M4Record":
        f = line.split()
        if len(f) < 12:
            raise ValueError(f"bad M4 line: {line!r}")
        return cls(qid=int(f[0]), sid=int(f[1]), identity=float(f[2]),
                   score=int(float(f[3])), qstrand=int(f[4]), qstart=int(f[5]),
                   qend=int(f[6]), qsize=int(f[7]), sstrand=int(f[8]),
                   sstart=int(f[9]), send=int(f[10]), ssize=int(f[11]),
                   qext=int(f[12]) if len(f) >= 14 else None,
                   sext=int(f[13]) if len(f) >= 14 else None)


@dataclass
class CandidateRecord:
    qid: int          # 1-based
    sid: int          # 1-based
    score: int
    qdir: int         # orientation of the query for this candidate
    qext: int         # seed position in the qdir-oriented query
    qsize: int
    sdir: int         # always 0
    sext: int         # seed position on the forward subject
    ssize: int

    @classmethod
    def parse(cls, line: str) -> "CandidateRecord":
        f = line.split()
        if len(f) < 9:
            raise ValueError(f"bad candidate line: {line!r}")
        return cls(qid=int(f[0]), sid=int(f[1]), score=int(float(f[2])),
                   qdir=int(f[3]), qext=int(f[4]), qsize=int(f[5]),
                   sdir=int(f[6]), sext=int(f[7]), ssize=int(f[8]))


def format_block(records: List[M4Record]) -> str:
    """M4 text of ``records``, one line each."""
    return "".join(r.format() + "\n" for r in records)


def format_candidate_columns(cols: dict) -> str:
    """Candidate lines from int columns (qid, sid, score, qdir, qext, qsize,
    sdir, sext, ssize), one line per row."""
    if len(cols["qid"]) == 0:
        return ""
    a = np.column_stack([np.asarray(cols[f], dtype=np.int64)
                         for f in ("qid", "sid", "score", "qdir", "qext",
                                   "qsize", "sdir", "sext", "ssize")])
    return "".join("\t".join(map(str, row)) + "\n" for row in a.tolist())


def _read(path: str, cls) -> Iterator:
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield cls.parse(line)


def read_m4(path: str) -> Iterator[M4Record]:
    """The M4 records of a file, blank lines skipped."""
    return _read(path, M4Record)


def read_candidates(path: str) -> Iterator[CandidateRecord]:
    """The candidate records of a file, blank lines skipped."""
    return _read(path, CandidateRecord)
