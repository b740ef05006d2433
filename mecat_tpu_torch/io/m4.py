"""M4 overlap records and candidate columns as text.

Copy of the writers of ``mecat_tpu.io.m4`` without its native C++ fast
path: the bytes are the same.  M4 line layout::

    qid sid identity score qstrand qstart qend qsize sstrand sstart send ssize

with 1-based read ids, the query on its forward strand (qstrand 0), 0-based
half-open coordinates on each read's forward strand and identity as %.2f.
``-g 1`` appends the seed columns qext, sext.  Candidate lines are
``qid sid score qdir qext qsize sdir sext ssize``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

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
