import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


#: a small PacBio-profile read set every read of which can overlap
TINY = dict(genome_size=24000, coverage=6, mean_len=4000, min_len=2500,
            error_rate=0.12, profile=[0.2, 0.55, 0.25])
TINY_PW = dict(num_candidates=8, min_align_size=2000, min_identity=70.0,
               kmer_size=13, scan_stride=10, max_occ=32, diag_bin=256,
               volume_bases=1 << 27, scan_batch=16, extend_batch=512,
               align_segment=512, align_band=128, min_block_score=2,
               print_ext=0, index_cutoff=None)
