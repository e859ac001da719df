"""What decides `correct`, driven end to end on the CPU at a small size
with the look for a card skipped: the control (the reference in
bfloat16 put in the program's place) fails in every cell, and each
fault a cell can have, planted in the program underneath the timed
path, turns `correct` false."""
import numpy as np
import pytest

CELLS = ("hl2d-bulk", "hl2d-updates", "hl2d-serve")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(small_run, cell):
    res = small_run(cell, with_control=True)
    assert res["control_correct"] is False
    ctl = res["control_compared"]
    assert ctl["sq_gap"]["value"] > ctl["sq_gap"]["limit"]
    # the program's own numbers on the same queries sit far below the
    # control's (ids: exact)
    assert res["compared"]["bad_ids"]["value"] == 0
    assert res["compared"]["failed"]["value"] == 0
    assert res["compared"]["sq_gap"]["value"] < ctl["sq_gap"]["value"] / 10


def _alter_answer(monkeypatch):
    """A token or an answer altered where it is produced: the first
    answer of every engine call that found one names the next point."""
    from repro_torch.query import engine

    real = engine.execute

    def execute(snapshot, queries, spec):
        res = real(snapshot, queries, spec)
        g = res.gids.copy()
        found = np.nonzero(g[:, 0] >= 0)[0]
        if len(found):
            g[found[0], 0] += 1
        return res._replace(gids=g)
    monkeypatch.setattr(engine, "execute", execute)


def _drop_half(monkeypatch):
    """Half of the batch left out: the index answers the first half of
    each call's queries and returns nothing for the rest."""
    from repro_torch.index import streaming

    real = streaming.StreamingIndex.constrained_knn

    def constrained_knn(self, queries, k, r):
        res = real(self, queries, k, r)
        half = (len(res.gids) + 1) // 2
        g, d = res.gids.copy(), res.distances.copy()
        g[half:], d[half:] = -1, np.inf
        return res._replace(gids=g, distances=d)
    monkeypatch.setattr(streaming.StreamingIndex, "constrained_knn", constrained_knn)


def _lose_writes(monkeypatch):
    """A step that returns its state unchanged: `add` acknowledges its
    points with ids but never inserts them."""
    from repro_torch.index import streaming

    def add(self, points, meta=None):
        pts = np.asarray(points, np.float32).reshape(-1, self.config.dim)
        with self._write_lock:
            return self.log.assign(len(pts))
    monkeypatch.setattr(streaming.StreamingIndex, "add", add)


def _drop_requests(monkeypatch):
    """Half of a dispatch's requests left out: they are never answered."""
    from repro_torch.serve import frontend

    real = frontend.SearchFrontend._take_batch

    def take(self, first):
        batch = real(self, first)
        return batch[: (len(batch) + 1) // 2]
    monkeypatch.setattr(frontend.SearchFrontend, "_take_batch", take)


FAULTS = [
    ("hl2d-bulk", _alter_answer, "id_sq_gap"),
    ("hl2d-bulk", _drop_half, "sq_gap"),
    ("hl2d-updates", _lose_writes, "sq_gap"),
    ("hl2d-updates", _alter_answer, "id_sq_gap"),
    ("hl2d-serve", _drop_requests, "failed"),
    ("hl2d-serve", _alter_answer, "id_sq_gap"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _ in FAULTS])
def test_fault_turns_correct_false(small_run, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    res = small_run(cell, wait_s=1.0)
    assert res["correct"] is False
    c = res["compared"][number]
    assert c["value"] > c["limit"]
