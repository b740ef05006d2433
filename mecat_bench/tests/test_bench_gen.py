"""The vectorised read generator and the truth-derived candidates."""
import numpy as np
import pytest

from mecat_bench.gen.candidates import overlapping_pairs, truth_candidates
from mecat_bench.gen.reads import profile_rates, simulate

REVCOMP = np.array([3, 2, 1, 0], dtype=np.uint8)


def _genome_of(sim, seed_cfg):
    """The genome as the generator drew it (its first draw)."""
    import torch
    g = torch.Generator(device="cpu")
    g.manual_seed(seed_cfg[1])
    return torch.randint(0, 4, (seed_cfg[0]["genome_size"],), generator=g,
                         dtype=torch.uint8).numpy()


@pytest.mark.parametrize("profile", [(0.2, 0.55, 0.25), (0.4, 0.2, 0.4)])
def test_profile_shares(profile):
    cfg = dict(genome_size=200_000, coverage=20, mean_len=5000,
               min_len=1000, error_rate=0.12, profile=list(profile))
    sim = simulate(cfg, 2 ** 31 + 12345, "cpu", keep_map=True)
    sub, ins, dele = profile_rates(cfg["error_rate"], profile)
    n_true = int(sim.g_len.sum())
    # read bases = true bases - deletions + insertions
    net = (int(sim.lengths.sum()) - n_true) / n_true
    assert net == pytest.approx(ins - dele * (1 - sub), abs=0.004)
    # a deleted base shares its read position with the next true base
    d = np.diff(sim.map_out.astype(np.int64))
    starts = sim.map_starts[1:]
    same = np.ones(len(d), dtype=bool)
    same[starts - 1] = False
    dels = int(((d == 0) & same).sum())
    assert dels / n_true == pytest.approx(dele * (1 - sub), rel=0.05)
    ins_seen = int(((d == 2) & same).sum())
    assert ins_seen / n_true == pytest.approx(ins * (1 - dele * (1 - sub)),
                                              rel=0.08)
    assert sim.lengths.min() >= 1
    assert sim.g_len.min() >= cfg["min_len"]
    assert sim.g_len.mean() == pytest.approx(cfg["mean_len"], rel=0.05)
    assert sim.n_reads == round(cfg["coverage"] * cfg["genome_size"]
                                / cfg["mean_len"])


def test_truth_map_places_every_read():
    cfg = dict(genome_size=60_000, coverage=8, mean_len=3000, min_len=1000,
               error_rate=0.0, profile=[0.4, 0.2, 0.4])
    seed = 77
    sim = simulate(cfg, seed, "cpu", keep_map=True)
    genome = _genome_of(sim, (cfg, seed))
    for r in range(sim.n_reads):
        g = np.arange(sim.g_start[r], sim.g_start[r] + sim.g_len[r])
        read = sim.codes[sim.starts[r]:sim.starts[r] + sim.lengths[r]]
        pos = sim.read_pos(r, g)
        want = genome[g] if sim.strand[r] == 0 else REVCOMP[genome[g]]
        assert np.array_equal(read[pos], want)
    # with errors every map is still a non-decreasing path through the read
    noisy = simulate(dict(cfg, error_rate=0.15), seed, "cpu", keep_map=True)
    for r in range(noisy.n_reads):
        m = noisy.map_out[noisy.map_starts[r]:
                          noisy.map_starts[r] + noisy.g_len[r]]
        assert m[0] <= 1 and np.all(np.diff(m) >= 0)
        assert m[-1] <= noisy.lengths[r]


def test_candidates_give_the_piles_coverage_predicts():
    cfg = dict(genome_size=300_000, coverage=30, mean_len=8000, min_len=2000,
               error_rate=0.12, profile=[0.4, 0.2, 0.4])
    sim = simulate(cfg, 99, "cpu", keep_map=True)
    a, b, lo, hi = overlapping_pairs(sim, 400)
    # brute force: every pair, by its intervals
    st, en = sim.g_start, sim.g_start + sim.g_len
    ov = np.minimum(en[:, None], en[None, :]) - np.maximum(st[:, None],
                                                          st[None, :])
    np.fill_diagonal(ov, -1)
    want = {(min(i, j), max(i, j)) for i, j in zip(*np.nonzero(ov >= 400))}
    got = {(min(i, j), max(i, j)) for i, j in zip(a, b)}
    assert got == want
    cols = truth_candidates(sim, 400)
    assert len(cols) == 2 * len(want)
    # a read in the genome's middle meets about coverage x (L + mean) / mean
    # reads; their records make its pile
    per_read = np.bincount(cols[:, 1] - 1, minlength=sim.n_reads)
    mid = (st > cfg["mean_len"] * 3) & (en < cfg["genome_size"]
                                        - cfg["mean_len"] * 3)
    pred = cfg["coverage"] * (sim.g_len[mid] + cfg["mean_len"] - 800) \
        / cfg["mean_len"]
    assert per_read[mid].mean() == pytest.approx(pred.mean(), rel=0.1)
    # seeds sit on the true diagonal: at zero error they pick the same base
    exact = simulate(dict(cfg, error_rate=0.0, genome_size=50_000), 5, "cpu",
                     keep_map=True)
    c = truth_candidates(exact, 400)
    for qid, sid, _, qdir, qext, qsize, _, sext, _ in c[:200]:
        q = exact.codes[exact.starts[qid - 1]:][:qsize]
        s = exact.codes[exact.starts[sid - 1]:]
        qb = q[qext] if qdir == 0 else REVCOMP[q[qsize - 1 - qext]]
        assert qb == s[sext]
