"""The comparison that decides ``correct``: served answers against the
reference's exact scores.

Each served answer is a row of ``k`` ids (``-1`` past its hits) and their
scores.  Over all answers checked:

* ``rank_gap``: the widest gap, as a share of the reference's k-th best
  score (or of its last hit, where it has fewer than ``k``), by which a
  served document's reference score lies below it; a served id that is
  no hit in the reference (dead at the pinned epoch, holds no query
  term, or unknown) reads 1.
* ``score_err``: the widest relative gap between a served hit's score and
  its reference score.
* ``missing``: hits the reference has and the answer leaves out, past
  what ``k`` allows (``min(k, hits) - served hits``), summed.
* ``dead_ids``: served ids that are not live at the answer's epoch.
* ``unanswered``: answers due that never came or came with an error.
* ``stale`` (live cells): answers that miss a write acknowledged before
  they were asked, although the write lock was free all the time they
  waited (a server may answer from its last view only while a writer
  holds the lock).

Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


class Tally:
    def __init__(self):
        self.rank_gap = 0.0
        self.score_err = 0.0
        self.missing = 0
        self.dead_ids = 0
        self.unanswered = 0
        self.stale = 0
        self.checked = 0

    def numbers(self) -> dict:
        return {"rank_gap": self.rank_gap, "score_err": self.score_err,
                "missing": self.missing, "dead_ids": self.dead_ids,
                "unanswered": self.unanswered, "stale": self.stale}


def _behind(answers, acks) -> list:
    """For each answer (asked, answered, epoch), whether it misses a
    write (acknowledged, epoch) acknowledged before it was asked."""
    acks = sorted(acks)
    t_ack = np.array([a for a, _ in acks], np.float64)
    newest = np.maximum.accumulate(np.array([e for _, e in acks],
                                            np.float64))
    out = []
    for asked, _, epoch in answers:
        n = int(np.searchsorted(t_ack, asked, side="left"))
        out.append(n > 0 and epoch < newest[n - 1])
    return out


def behind(answers, acks) -> int:
    """Answers that miss a write acknowledged before they were asked."""
    return int(sum(_behind(answers, acks)))


def stale(answers, acks, holds) -> int:
    """Answers that miss a write acknowledged before they were asked
    while no span of ``holds`` (t0, t1), the times the write lock may
    have been held, meets the time they waited."""
    holds = sorted(holds)
    h0 = np.array([a for a, _ in holds], np.float64)
    h1 = np.maximum.accumulate(np.array([b for _, b in holds], np.float64))
    n = 0
    for (asked, answered, _), late in zip(answers, _behind(answers, acks)):
        if not late:
            continue
        # the holds that began before the answer came; did one end
        # after the query was asked?
        i = int(np.searchsorted(h0, answered, side="right"))
        if i == 0 or h1[i - 1] < asked:
            n += 1
    return n


def judge(tally: Tally, final: torch.Tensor, live: torch.Tensor,
          ids: np.ndarray, scores: np.ndarray, k: int) -> None:
    """Add the answers ``ids``/``scores`` [Q, k] to ``tally``, judged by
    the reference's final scores ``final`` [Q, num_docs] (``-inf`` for no
    hit) over the live mask ``live``."""
    n_docs = final.shape[1]
    q = final.shape[0]
    kk = min(k, n_docs)
    best = torch.topk(final, kk, dim=1).values.double().cpu().numpy()
    hits = torch.isfinite(final).sum(dim=1).cpu().numpy()
    ids = np.asarray(ids, np.int64).reshape(q, -1)
    scores = np.asarray(scores, np.float64).reshape(q, -1)
    valid = (ids >= 0) & (ids < n_docs)
    safe = torch.from_numpy(np.where(valid, ids, 0)).to(final.device)
    ref = torch.gather(final, 1, safe).double().cpu().numpy()
    alive = live[safe].cpu().numpy()
    for i in range(q):
        served = ids[i] >= 0
        tally.checked += 1
        tally.dead_ids += int((served & ~(valid[i] & alive[i])).sum())
        want = min(k, int(hits[i]))
        tally.missing += max(0, want - int(served.sum()))
        if not served.any():
            continue
        bar = best[i, want - 1] if want else np.inf
        r = np.where(valid[i], ref[i], -np.inf)[served]
        gap = np.where(np.isfinite(r), (bar - r) / bar if want else 1.0, 1.0)
        tally.rank_gap = max(tally.rank_gap, float(np.max(gap, initial=0.0)))
        ok = np.isfinite(r)
        if ok.any():
            err = np.abs(scores[i][served][ok] - r[ok]) / np.abs(r[ok])
            tally.score_err = max(tally.score_err, float(err.max()))


def control_answers(final: torch.Tensor, k: int):
    """The control's answers: the top ``k`` of its own (lower-precision)
    final scores, as ids and f32 scores."""
    kk = min(k, final.shape[1])
    vals, top = torch.topk(final, kk, dim=1)
    hit = torch.isfinite(vals)
    ids = torch.where(hit, top, -1).cpu().numpy()
    sc = torch.where(hit, vals, torch.zeros_like(vals)).float().cpu().numpy()
    if kk < k:
        ids = np.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
        sc = np.pad(sc, ((0, 0), (0, k - kk)))
    return ids, sc

