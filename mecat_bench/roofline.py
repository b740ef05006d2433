"""Least times of the benchmark's kernels, from the work the data needs.

A banded edit-distance DP cell costs, in any exact implementation, at least
``DP_OPS_PER_CELL`` 32-bit integer operations: a bit-parallel banded DP
(Myers 1999; Hyyro 2003) advances 32 cells of a row with about 15 word
operations, which three-input logic folds to no fewer than 8, so a quarter
of an operation a cell.  The cells are those the plain reference's
extensions need (rows each live segment consumes x band width), never the
program's own counters, so a kernel that does less work a cell reads a
higher share, and none can pass 100 %.  Bytes are the query and target
bases those rows read, each once.  The least time is the larger of
operations over the integer peak and bytes over the memory peak
(``peaks.json``).
"""
from __future__ import annotations

import json
import os

DP_OPS_PER_CELL = 0.25


def peaks(kind: str) -> dict:
    """The peak table of device ``kind`` (``torch.cuda.get_device_name``);
    the H100 SXM row for an unknown name."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as fh:
        table = json.load(fh)
    return table.get(kind, table["NVIDIA H100 80GB HBM3"])


def dp_least_seconds(tally: dict, peak: dict) -> float:
    """Least seconds for the DP work of a reference tally (its ``cells``,
    ``q_bytes``, ``t_bytes``)."""
    ops = tally["cells"] * DP_OPS_PER_CELL
    nbytes = tally["q_bytes"] + tally["t_bytes"]
    return max(ops / peak["int_op_per_s"], nbytes / peak["hbm_bytes_per_s"])
