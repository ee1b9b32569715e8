"""Faults planted under a cell's timed path, so that a run's ``correct``
can be seen to come out false: in the CPU tests
(``test_perfbench_run.py``) and on the card (``tools/control.py --side
<fault>``).

  half_the_batch    the second half of each batch's answers left out
  altered_answer    answers altered where they are produced
  stale_answer      each call returns the previous call's answers
  wrong_candidates  the sketch's candidates of every other lane moved by
                    half a tile: the re-rank ranks the wrong rows exactly,
                    so every value it returns stays right
"""

from __future__ import annotations

FAULTS = ("half_the_batch", "altered_answer", "stale_answer",
          "wrong_candidates")


def plant(fault: str, set_attr=setattr) -> None:
    """Plant ``fault`` in the program's classes and modules through
    ``set_attr`` (a test's ``monkeypatch.setattr``, or ``setattr`` in a
    process that runs nothing else)."""
    from repro_torch.engine import engine as eng_mod
    from repro_torch.kernels import ops

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    if fault == "wrong_candidates":
        nearest = ops.hamming_nearest

        def bad_nearest(ucodes, item_codes, item_mask, n_cand):
            cand = nearest(ucodes, item_codes, item_mask, n_cand).clone()
            rows = item_codes.shape[0]
            cand[1::2] = (cand[1::2] + rows // 2) % rows
            return cand

        set_attr(ops, "hamming_nearest", bad_nearest)
        return

    query_batch = eng_mod.RkMIPSEngine.query_batch
    kmips = eng_mod.RkMIPSEngine.kmips
    state = {}

    def bad_query_batch(self, queries, k):
        res = query_batch(self, queries, k)
        pred = res.predictions.clone()
        if fault == "half_the_batch":
            pred[pred.shape[0] // 2:] = False
        elif fault == "altered_answer":
            pred[:, ::7] = ~pred[:, ::7]
        else:
            pred, state["last"] = state.get("last", pred), pred
        return res._replace(predictions=pred)

    def bad_kmips(self, q, k, **kw):
        res = kmips(self, q, k, **kw)
        ids, vals = res.ids.clone(), res.values.clone()
        if fault == "half_the_batch":
            ids[ids.shape[0] // 2:] = -1
        elif fault == "altered_answer":
            ids[::5, 0] = (ids[::5, 0] + 1) % (int(ids.max()) + 1)
        else:
            (ids, vals), state["last"] = state.get("last", (ids, vals)), (
                ids, vals)
        return res._replace(ids=ids, values=vals)

    set_attr(eng_mod.RkMIPSEngine, "query_batch", bad_query_batch)
    set_attr(eng_mod.RkMIPSEngine, "kmips", bad_kmips)
