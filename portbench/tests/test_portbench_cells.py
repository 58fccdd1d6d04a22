"""The cells end to end on the CPU at a tiny size: a sound run is
correct, the control (the reference in bfloat16 in the program's place)
is not, and each fault the cells can have, planted in the program under
the timed path, makes ``correct`` false."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _tiny  # noqa: E402

LIVE = "live1m.search_write"
STATIC = "static1m_packed.batch_eval"


def failing(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", [LIVE, STATIC])
def test_sound_run_is_correct_and_the_control_is_not(cell):
    line, numbers = _tiny.run(cell, control=True)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    limits = {k: c["limit"] for k, c in line["checks"].items()}
    control = numbers["control"]
    assert any(control[k] > limits[k] for k in limits), control
    # the control misses by far more than the program's own rounding
    assert control["score_err"] > 30 * numbers["program"]["score_err"]


def _blank_half(result, query_hashes):
    """Leaves out the later half of the batch's real queries (a padded
    batch's empty rows are no queries)."""
    real = np.flatnonzero((np.asarray(query_hashes) != 0).any(axis=1))
    gone = torch.from_numpy(real[len(real) // 2:])
    ids, sc = result.doc_ids.clone(), result.scores.clone()
    ids[gone] = -1
    sc[gone] = 0.0
    return type(result)(doc_ids=ids, scores=sc)


def _alter_one(result, query_hashes):
    ids = result.doc_ids.clone()
    ids[0, 0] = (ids[0, 0] + 1) % 1000
    return type(result)(doc_ids=ids, scores=result.scores)


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_live_fault_is_caught(monkeypatch, fault):
    from repro_torch.core import live_index
    topk = live_index.LiveView.topk
    change = _blank_half if fault == "half_batch" else _alter_one

    def broken(self, query_hashes, *a, **kw):
        out = topk(self, query_hashes, *a, **kw)
        return (change(out[0], query_hashes), out[1]) \
            if kw.get("return_stats") else change(out, query_hashes)
    monkeypatch.setattr(live_index.LiveView, "topk", broken)
    line, _ = _tiny.run(LIVE)
    assert not line["correct"] and failing(line["checks"])


def test_live_writes_left_unapplied_are_caught(monkeypatch):
    """A write step that returns the index's state unchanged (only the
    epoch moves)."""
    from repro_torch.core import live_index
    real_add = live_index.SegmentedIndex.add_batch
    real_delete = live_index.SegmentedIndex.delete
    state = {"window": False}

    def add(self, corpus, **kw):
        if not kw.get("refresh_norms", True):     # the window's writes
            state["window"] = True
            self._bump_epoch()
            return None
        return real_add(self, corpus, **kw)

    def delete(self, ids):
        if state["window"]:
            self._bump_epoch()
            return None
        return real_delete(self, ids)
    monkeypatch.setattr(live_index.SegmentedIndex, "add_batch", add)
    monkeypatch.setattr(live_index.SegmentedIndex, "delete", delete)
    line, _ = _tiny.run(LIVE)
    assert not line["correct"] and failing(line["checks"])


def test_live_view_pinned_before_the_window_is_caught(monkeypatch):
    """A server that keeps answering from the view it pinned before the
    window: every answer is exact at the epoch it reports, and stale."""
    from repro_torch.serve import server
    monkeypatch.setattr(server.QueryServer, "refresh_view",
                        lambda self: self._pinned)
    line, _ = _tiny.run(LIVE)
    assert not line["correct"] and failing(line["checks"]) == ["stale"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer"])
def test_static_fault_is_caught(monkeypatch, fault):
    from repro_torch.core import query
    make = query.make_scorer
    change = _blank_half if fault == "half_batch" else _alter_one

    def broken(*a, **kw):
        scorer = make(*a, **kw)
        return lambda qh: change(scorer(qh), qh)
    monkeypatch.setattr(query, "make_scorer", broken)
    line, _ = _tiny.run(STATIC)
    assert not line["correct"] and failing(line["checks"])


def test_reference_epochs_follow_the_writes():
    """Every answer pinned an epoch at or after set-up's, and the live
    set the reference rebuilds at the last epoch is the index's own."""
    from portbench.lib import cell as cell_mod, manifest as mf
    from portbench.reference import compare
    m = mf.load()
    cfg = cell_mod.merged(mf.config(m, "live1m"), _tiny.LIVE)
    mix = cell_mod.merged(mf.traffic("search_write"), _tiny.LIVE_MIX)
    system = mf.module("deployments", "live_index").build(
        cfg, _tiny.SEED, "cpu", False)
    sess = mf.module("loads", "open_loop_serve").Session(
        system, mix, _tiny.SEED, 0.8)
    sess.warm()
    sess.window()
    try:
        assert np.array_equal(system.live_at(system.si.epoch),
                              system.si.live_mask())
        assert all(r.epoch >= sess.epoch0 for r in sess.responses)
        assert compare.stale(sess.answers(), sess.acks(),
                             sess.lock_holds()) == 0
        assert len(sess.writes) == len(sess.write_due)
    finally:
        system.release()
