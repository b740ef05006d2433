"""Correction rounds > 1 of the port (mecat_tpu_torch.pipeline.cns) vs the JAX
package, exact equality everywhere.

``call_tables`` under ``draft_mode`` and ``keep_template`` on seeded tables
full of ties and thin coverage (also against the port's own NumPy
``CnsTable``); ``emit_to_draft``; ``append_drafts`` (a template with no
draft, an empty draft, a seed past the map's end); the addressing of
``append_device_volume``; ``correct_batch_rounds`` with 2 and 3 rounds on the
pile of ``tests/test_cns_device.py`` against the JAX device route and against
the port's host route, with no window start clamping anywhere; independence
of the batch size; ``draft_est_coverage``; and the CLI with ``--rounds 2``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one thread is as fast, and several test workers share the cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from mecat_tpu.io.packed_db import PackedDB as RefDB
from mecat_tpu.ops import consensus as ref_cons
from mecat_tpu.ops import consensus_device as ref_dev
from mecat_tpu.pipeline import cns as ref
from mecat_tpu_torch.cli import mecat2cns
from mecat_tpu_torch.io.fasta import FastaRecord, iter_fasta
from mecat_tpu_torch.io.packed_db import revcomp
from mecat_tpu_torch.ops import consensus as port_cons
from mecat_tpu_torch.ops import consensus_device as port_dev
from mecat_tpu_torch.pipeline import cns as port
from mecat_tpu_torch.testing import PILE_CNS, cns_pile

D1 = 16
#: templates of the two-round runs, and of the smaller runs (rounds = 3,
#: draft_est_coverage, batches)
MAIN, SUBSET = 16, 9


def _tables(seed, T=4, L=160, depth=9):
    """Random tag tables: small counts (so plurality ties are common),
    homopolymer-rich templates, coverage that dips under the thresholds,
    one row without support, one short row."""
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 4, (T, L)).astype(np.uint8)
    runs = rng.random((T, L)) < 0.45          # extend the previous letter
    for i in range(1, L):
        template[:, i] = np.where(runs[:, i], template[:, i - 1],
                                  template[:, i])
    tlen = np.array([L, L - 17, L // 2, L][:T], np.int32)
    counts = rng.integers(0, 4, (T, L, D1, 5)).astype(np.int32)
    counts[:, :, 0, :] += (depth * (np.arange(5)[None, None, :]
                                    == template[:, :, None])).astype(np.int32)
    counts[:, :, 0, 4] *= rng.integers(0, 4, (T, L)).astype(np.int32)
    counts[:, :, 1:, :] *= (rng.random((T, L, D1 - 1, 1)) < 0.25)
    counts[:, :, 1:, 4] = 0
    counts[:, :, 3:, :] //= 3
    cov_diff = np.zeros((T, L + 1), np.int32)
    for t in range(T):
        for k in range(depth):
            a, b = sorted(rng.integers(0, L + 1, 2))
            if k % 3 == 0:                    # every third span is long
                a, b = a // 3, L - (L - b) // 3
            cov_diff[t, a] += 1
            cov_diff[t, b] -= 1
    has = np.ones(T, bool)
    has[-1] = False
    return counts, cov_diff, template, tlen, has


MODES = {"draft": dict(draft_mode=True), "polish": dict(keep_template=True)}
WINDOW = dict(del_bias100=50, ins_bias100=70, pool_min_cov=5,
              pool_min_cov_ins=5, win_radius=4, win_mass_frac100=40,
              win_peak_frac100=20)


@pytest.mark.parametrize("vote", ["default", "window"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed,min_cov", [(1, 4), (2, 2), (3, 6)])
def test_call_tables_modes_match_jax(seed, min_cov, mode, vote):
    counts, cov_diff, template, tlen, has = _tables(seed)
    kw = WINDOW if vote == "window" else None
    want_emit, want_ok = ref_dev.call_tables(
        jnp.asarray(counts), jnp.asarray(cov_diff), jnp.asarray(template),
        jnp.asarray(tlen), jnp.asarray(has), jnp.int32(min_cov),
        vote=ref_cons.VoteParams(**kw) if kw else None, **MODES[mode])
    c = torch.as_tensor(counts.copy())
    got_emit, got_ok = port_dev.call_tables(
        c, torch.as_tensor(cov_diff), torch.as_tensor(template),
        torch.as_tensor(tlen), torch.as_tensor(has), min_cov,
        vote=port_cons.VoteParams(**kw) if kw else None, **MODES[mode])
    want_emit = np.asarray(want_emit)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_emit.numpy(), want_emit)
    coverage = np.cumsum(cov_diff[:, :-1], axis=1)
    in_read = np.arange(template.shape[1])[None, :] < tlen[:, None]
    thin = (coverage < min_cov) & in_read
    assert thin[:-1].sum() > 10 and (~thin & in_read)[:-1].sum() > 40
    # thin coverage keeps the template base; the polish also on the row
    # that has no support, the draft only on supported rows
    kept = thin if mode == "polish" else thin & has[:, None]
    np.testing.assert_array_equal(want_emit[:, :, 0][kept], template[kept])
    if mode == "polish":      # no self-vote: the table is left as it was
        np.testing.assert_array_equal(c.numpy(), counts)
    else:
        assert (want_emit[-1] == -1).all()
        assert (c.numpy() - counts).sum() == int(tlen[:-1].sum())


@pytest.mark.parametrize("seed,min_cov", [(5, 3), (6, 5)])
def test_call_tables_modes_match_the_ports_cns_table(seed, min_cov):
    """The device vote against the port's own host vote, row by row:
    ``call_draft`` (draft mode) and ``call_polished`` (keep_template)."""
    counts, cov_diff, template, tlen, has = _tables(seed)
    has[:] = True
    args = lambda: (torch.as_tensor(counts.copy()), torch.as_tensor(cov_diff),
                    torch.as_tensor(template), torch.as_tensor(tlen),
                    torch.as_tensor(has), min_cov)
    draft, _ = port_dev.call_tables(*args(), draft_mode=True)
    polished, _ = port_dev.call_tables(*args(), keep_template=True)
    for i in range(len(tlen)):
        n = int(tlen[i])
        table = port_cons.CnsTable(template[i, :n])
        table.counts[:] = counts[i, :n]
        table.coverage[:] = np.cumsum(cov_diff[i, :n])
        flat = polished[i, :n].numpy().reshape(-1)
        np.testing.assert_array_equal(
            flat[flat >= 0], table.call_polished(min_coverage=min_cov))
        table.add_template_votes()
        want, want_map = table.call_draft(min_coverage=min_cov)
        got, got_map = port_cons.emit_to_draft(draft[i, :n].numpy())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_map, want_map)
        assert len(want) > n // 2


def test_emit_to_draft_matches_reference():
    rng = np.random.default_rng(9)
    emit = rng.integers(-1, 4, (70, 5)).astype(np.int8)
    emit[rng.random(70) < 0.2] = -1           # deleted positions
    got, got_map = port_cons.emit_to_draft(emit)
    want, want_map = ref_cons.emit_to_draft(emit)
    assert got.dtype == want.dtype and got_map.dtype == want_map.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_map, want_map)
    assert got_map[-1] == len(got) and got_map[0] == 0
    empty, m = port_cons.emit_to_draft(np.full((4, 3), -1, np.int8))
    assert len(empty) == 0 and m.tolist() == [0, 0, 0, 0, 0]


def _small_dbs():
    rng = np.random.default_rng(31)
    recs = [FastaRecord(f"x{i}", rng.integers(0, 4, n, dtype=np.uint8))
            for i, n in enumerate((900, 1400, 1100, 700))]
    return port.PackedDB.from_records(recs), RefDB.from_records(recs)


def test_append_drafts_matches_reference():
    db, rdb = _small_dbs()
    rng = np.random.default_rng(32)
    by = {0: [(1, 0, 10, 5, 90), (2, 1, 700, 899, 80), (3, 0, 5, 5000, 70)],
          1: [(0, 0, 3, 3, 50)],
          2: [(3, 1, 8, 1099, 40)]}
    # template 0: a draft shorter than the read (the last seed lies past
    # the map's end and past the draft); template 1: an empty draft;
    # template 2: no draft at all; template 3: no supports, no draft
    draft0 = rng.integers(0, 4, 850, dtype=np.uint8)
    map0 = np.minimum(np.arange(901, dtype=np.int32), 850)
    drafts = {0: (draft0, map0),
              1: (np.zeros(0, np.uint8), np.zeros(1401, np.int32))}
    ids = [0, 1, 2, 3]
    g_db, g_ids, g_by, g_old = port.append_drafts(db, ids, by, drafts)
    w_db, w_ids, w_by, w_old = ref.append_drafts(rdb, ids, by, drafts)
    assert (g_ids, g_old) == (w_ids, w_old) == ([4, 1, 2, 3], 4)
    assert g_by == w_by
    assert g_by[4] == [(1, 0, 10, 5, 90), (2, 1, 700, 849, 80),
                       (3, 0, 5, 849, 70)]
    assert g_by[1] == by[1] and g_by[2] == by[2] and 3 not in g_by
    for name in ("codes", "starts", "lengths"):
        np.testing.assert_array_equal(getattr(g_db, name),
                                      getattr(w_db, name), err_msg=name)
    assert g_db.names == w_db.names == ["x0", "x1", "x2", "x3", "x0"]
    # a columnar SupportTable keeps an undrafted template's rows as well
    table = port.SupportTable(np.array([2, 0]), np.array(
        [[3, 1, 8, 1099, 40], [1, 0, 10, 5, 90]]))
    _, _, t_by, _ = port.append_drafts(db, ids, table, drafts)
    np.testing.assert_array_equal(t_by[2], [[3, 1, 8, 1099, 40]])
    assert t_by[4] == [(1, 0, 10, 5, 90)]


def test_append_device_volume_addressing():
    db, rdb = _small_dbs()
    rng = np.random.default_rng(33)
    drafts = [FastaRecord("x0", rng.integers(0, 4, 880, dtype=np.uint8)),
              FastaRecord("x2", rng.integers(0, 4, 1130, dtype=np.uint8))]
    vol = port.device_volume(db, "cpu")
    db2 = db.append(drafts)
    vol2 = port.append_device_volume(vol, db2, db.n_reads)
    cat = vol2.vol_cat.numpy()
    assert vol2.n_bases == vol.n_bases == db.total_bases
    assert vol2.starts.dtype == torch.int64
    np.testing.assert_array_equal(cat[:len(vol.vol_cat)], vol.vol_cat.numpy())
    for r in range(db.n_reads):               # old reads, both strands
        s, n = int(vol2.starts[r]), int(vol2.lengths[r])
        np.testing.assert_array_equal(cat[s:s + n], db.read(r))
        rc0 = 2 * vol2.n_bases - s - n
        np.testing.assert_array_equal(cat[rc0:rc0 + n], revcomp(db.read(r)))
    for k, rec in enumerate(drafts):          # the drafts, forward only
        s, n = (int(vol2.starts[db.n_reads + k]),
                int(vol2.lengths[db.n_reads + k]))
        assert s >= len(vol.vol_cat) and n == len(rec.codes)
        np.testing.assert_array_equal(cat[s:s + n], rec.codes)
    tail_end = int(vol2.starts[-1]) + int(vol2.lengths[-1])
    assert len(cat) - tail_end == 3 * 1130 + 1024
    assert not cat[tail_end:].any()
    # the same arrays as the reference's grow-by-concatenate route, which
    # pads the uploaded tail to a length bucket: more zeros at its end
    want = ref.append_device_volume(ref.device_volume(rdb),
                                    rdb.append(drafts), rdb.n_reads)
    want_cat = np.asarray(want[0])
    np.testing.assert_array_equal(cat, want_cat[:len(cat)])
    assert len(want_cat) >= len(cat) and not want_cat[len(cat):].any()
    np.testing.assert_array_equal(vol2.starts.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(vol2.lengths.numpy(), np.asarray(want[2]))
    assert vol2.n_bases == want[3]
    # a draft's rows gather like a read's, zero past its end
    rows = port._gather_rows_dev(vol2.vol_cat, vol2.starts, vol2.lengths,
                                 torch.tensor([5, 4]), 2048).numpy()
    np.testing.assert_array_equal(rows[0, :1130], drafts[1].codes)
    np.testing.assert_array_equal(rows[1, :880], drafts[0].codes)
    assert not rows[0, 1130:].any() and not rows[1, 880:].any()


@pytest.fixture(scope="module")
def pile(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rounds")
    db, reads, cand = cns_pile(str(d), device="cpu")
    rdb = RefDB.from_fasta(reads)
    return dict(db=db, ref_db=rdb, reads=reads, cand=cand, dir=d,
                by=port.load_supports(cand, db, 0),
                ref_by=ref.load_supports(cand, rdb, 0))


def _as_dict(records):
    out = {n: np.asarray(s).tobytes() for n, s in records}
    assert len(out) == len(records)
    return out


def _run_ref(pile, templates, **kw):
    st = ref.CnsStats()
    out = list(ref.correct_batch_rounds(
        pile["ref_db"], templates, pile["ref_by"],
        ref.CnsOptions(**PILE_CNS, **kw), st,
        correct=ref.correct_batch_device))
    return out, st


def _run_port(pile, templates, host=False, **kw):
    st = port.CnsStats()
    out = list(port.correct_batch_rounds(
        pile["db"], templates, pile["by"], port.CnsOptions(**PILE_CNS, **kw),
        st, device="cpu", host=host))
    return out, st


@pytest.fixture(scope="module")
def rounds2(pile):
    """Two rounds over the first MAIN templates on the port's device
    route."""
    return _run_port(pile, sorted(pile["by"])[:MAIN], rounds=2)


def test_rounds2_matches_jax_and_the_host_route(pile, rounds2):
    templates = sorted(pile["by"])[:MAIN]
    got, ps = rounds2
    want, rs = _run_ref(pile, templates, rounds=2)
    assert [n for n, _ in got] == [n for n, _ in want] and len(want) >= MAIN
    assert _as_dict(got) == _as_dict(want)
    for name in ("templates", "supports_aligned", "corrected_reads",
                 "corrected_bases"):
        assert getattr(ps, name) == getattr(rs, name), name
    host, hs = _run_port(pile, templates, host=True, rounds=2)
    assert _as_dict(host) == _as_dict(got)
    # templates are counted once, supports once per round
    one, s1 = _run_port(pile, templates)
    assert ps.templates == hs.templates == s1.templates == len(templates)
    assert ps.supports_aligned == hs.supports_aligned \
        == 2 * s1.supports_aligned
    assert ps.dp_lane_segs_useful > s1.dp_lane_segs_useful
    assert _as_dict(one) != _as_dict(got)     # the second round binds


def test_rounds3_matches_jax_and_no_window_start_clamps(pile, monkeypatch):
    templates = sorted(pile["by"])[:SUBSET]
    gather = port._gather_windows
    seen = []

    def checked(vol_cat, start, L):
        assert int(start.min()) >= 0
        assert int(start.max()) + L <= vol_cat.shape[0]
        seen.append(int(vol_cat.shape[0]))
        return gather(vol_cat, start, L)

    monkeypatch.setattr(port, "_gather_windows", checked)
    got, ps = _run_port(pile, templates, rounds=3)
    monkeypatch.undo()
    assert len(set(seen)) == 3                # the volume grew twice
    want, rs = _run_ref(pile, templates, rounds=3)
    assert _as_dict(got) == _as_dict(want) and len(want) >= SUBSET
    assert ps.supports_aligned == rs.supports_aligned
    host, _ = _run_port(pile, templates, host=True, rounds=3)
    assert _as_dict(host) == _as_dict(got)


def test_rounds_output_independent_of_the_batch_size(pile, rounds2):
    templates = sorted(pile["by"])[:SUBSET]
    names = {pile["db"].name(t) for t in templates}
    whole = {n: s for n, s in _as_dict(rounds2[0]).items()
             if n.rsplit("_", 1)[0] in names}
    st = port.CnsStats()
    got = []
    dev_vol = port.device_volume(pile["db"], "cpu")
    for ofs in range(0, SUBSET, 4):
        got += list(port.correct_batch_rounds(
            pile["db"], templates[ofs:ofs + 4], pile["by"],
            port.CnsOptions(rounds=2, **PILE_CNS), st, device="cpu",
            dev_vol=dev_vol, cap=1 << 22))
    assert _as_dict(got) == whole and len(whole) >= SUBSET
    assert st.templates == SUBSET


def test_draft_est_coverage_matches_jax(pile, rounds2):
    templates = sorted(pile["by"])[:SUBSET]
    kw = dict(rounds=2, draft_est_coverage=3)
    got, ps = _run_port(pile, templates, **kw)
    want, rs = _run_ref(pile, templates, **kw)
    assert _as_dict(got) == _as_dict(want)
    assert ps.supports_aligned == rs.supports_aligned
    # the draft round aligned fewer supports than a full round does
    full = {n: s for n, s in _as_dict(rounds2[0]).items() if n in dict(got)}
    _, s1 = _run_port(pile, templates)
    assert s1.supports_aligned < ps.supports_aligned \
        < 2 * s1.supports_aligned
    assert _as_dict(got) != full


def test_cli_rounds2_matches_the_api(pile, tmp_path):
    """``--rounds 2 --draft-est-coverage`` through the CLI on the candidate
    lines that name one of the first three reads: the bytes of ``run_cns``
    under the same preset-resolved options, and not those of one round."""
    cut = str(tmp_path / "cut.txt")
    with open(pile["cand"]) as fh, open(cut, "w") as oh:
        oh.writelines(ln for ln in fh
                      if {ln.split()[0], ln.split()[1]} & {"1", "2", "3"})
    flags = ["-i", "0", "-a", "300", "-l", "500", "--extend-batch", "32",
             "--align-segment", "128", "--align-band", "64", "-p", "5",
             "--device", "cpu"]
    out = {}
    for rounds in ("1", "2"):
        path = str(tmp_path / f"cli{rounds}.fasta")
        extra = ["--draft-est-coverage", "12"] if rounds == "2" else []
        assert mecat2cns.main([*flags, "--rounds", rounds, *extra, cut,
                               pile["reads"], path]) == 0
        with open(path, "rb") as fh:
            out[rounds] = fh.read()
    api = str(tmp_path / "api.fasta")
    stats = port.run_cns(cut, pile["reads"], api, port.CnsOptions.for_tech(
        0, rounds=2, draft_est_coverage=12, **PILE_CNS), device="cpu")
    with open(api, "rb") as fh:
        assert fh.read() == out["2"]
    assert out["2"] != out["1"] and out["2"].count(b">") >= 3
    assert stats.corrected_reads == out["2"].count(b">")
    names = [r.name for r in iter_fasta(pile["reads"])]
    got = {r.name.rsplit("_", 1)[0] for r in iter_fasta(api)}
    assert set(names[:3]) <= got
