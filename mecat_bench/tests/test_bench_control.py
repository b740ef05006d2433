"""The controls come out not correct, at a size a test run holds.

The control puts the plain reference in the program's place, judged as a
run judges the program: for the overlap cell at the precision below the
configuration's (its float32 arithmetic in bfloat16), for the correction
cell with its piles cut at an estimated coverage of 20 instead of 25.  On
the card it runs at each cell's own size through ``run.py --control 1``.
"""

import torch

from mecat_bench import harness
from mecat_bench.kinds import cns as kcns
from mecat_bench.kinds import pw as kpw
from mecat_bench.tests.conftest import TINY, TINY_PW


def test_pw_m4_control_fails():
    wl, cfg, traffic = harness.cell_spec("ecoli-pacbio.pw-m4")
    cfg = dict(cfg, **TINY)
    cfg["pw_options"] = dict(TINY_PW)
    checks = kpw.control(cfg, dict(traffic, control_units=3, check_units=2),
                         31337, torch.device("cpu"))
    assert checks["m4_lines_differing"][0] > 0


def test_cns_control_fails():
    wl, cfg, traffic = harness.cell_spec("yeast-ont.cns")
    cfg = dict(cfg, genome_size=9000, coverage=40, mean_len=3000,
               min_len=2000)
    traffic = dict(traffic, table_cap_bytes=32 * 4096 * 16 * 5 * 4,
                   check_templates=4, control_units=3, check_units=1)
    checks = kcns.control(cfg, traffic, 4242424242, torch.device("cpu"))
    assert checks["corrected_segments_differing"][0] > 0
