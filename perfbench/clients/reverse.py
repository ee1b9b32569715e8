"""Reverse k-MIPS cells: closed loop, one client, batches of reverse
queries through ``RkMIPSEngine.query_batch``.

Set-up makes the configuration's catalogue on the device from its
``catalogue_seed``, builds the index (the configuration's engine
settings; its random draws from ``index_seed``) and runs one batch of
the cell's shape, drawn apart from the window's. Each batch of the
window sends the next draw of the mix, and the window ends on a whole
pass over the query pool once the run's seconds have passed, so every
seed does the same work. Every batch's whole (batch, m) prediction
matrix is kept on the device and, once the window has closed and the
program's state is freed, judged against the plain reference
(``judge``).

In the traced run, ``core.sah.rkmips_plan`` and ``rkmips_execute`` are
wrapped from here (no program file changes) in spans that start and end
at a device sync; after the window, whole batches run with each phase
under a profiler session of its own, for ``profile_seconds`` and until
a lane has been left to the execute's scan.
"""

from __future__ import annotations

import torch

from perfbench.data import synthetic
from perfbench.harness import traffic

UNIT = "queries"


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.k = int(self.mix["k"])
        self.kept: list[tuple[torch.Tensor, torch.Tensor]] = []

    # -- set-up --------------------------------------------------------

    def setup(self) -> None:
        self.prepare()
        self.build()
        self._run(self.warm.next())     # the warm batch, judged as well
        if self.ctx.trace:
            self.ctx.rec.warm_profiler()
            self._wrap_phases()

    def prepare(self) -> None:
        """The catalogue and the query draws, from the configuration and
        the seed: no program call."""
        ctx, cfg = self.ctx, self.cfg
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(cfg["catalogue_seed"])
        self.items, self.users = synthetic.recommendation_data(
            gen, cfg["n_items"], cfg["m_users"], cfg["d"])
        batch = int(self.mix["batch"])
        pool = traffic.norm_pool(self.items, self.mix["norm_rank"], batch)
        self.draws = traffic.ItemDraws(pool, batch, ctx.seed)
        self.warm = traffic.ItemDraws(pool, batch, ctx.seed, stream=3)

    def build(self) -> None:
        """The index (the configuration's engine settings; its random
        draws from the configuration's ``index_seed``)."""
        from repro_torch.engine import RkMIPSEngine
        from repro_torch.engine.config import EngineConfig
        build_gen = torch.Generator()
        build_gen.manual_seed(self.cfg["index_seed"])
        self.engine = RkMIPSEngine(EngineConfig(**self.cfg["engine"]),
                                   device=self.ctx.device)
        self.engine.build(self.items, self.users, build_gen)
        self.ctx.rec.counters["build_seconds"] = self.engine.build_seconds

    # -- the timed path ------------------------------------------------

    def _run(self, qids=None):
        qids = (self.draws.next() if qids is None else qids).to(
            self.ctx.device)
        res = self.engine.query_batch(self.items[qids], self.k)
        self.kept.append((qids, res.predictions))
        return res

    def batch(self) -> int:
        from repro_torch.kernels import ops
        rec = self.ctx.rec
        before = _tile_launches(ops)
        res = self._run()
        if self.ctx.trace:
            rec.add("scan_lanes", res.funnel.scan_lanes)
            rec.add("chunks", res.funnel.chunks)
            rec.add("tile_steps", _tile_launches(ops) - before)
        return res.predictions.shape[0]

    def may_end(self) -> bool:
        """The window may close only after a whole pass."""
        return self.draws.at_pass_end

    # -- tracing ---------------------------------------------------------

    def _wrap_phases(self) -> None:
        from repro_torch.core import sah
        rec = self.ctx.rec
        self._profiling = False
        orig = {name: getattr(sah, name)
                for name in ("rkmips_plan", "rkmips_execute")}

        def wrap(name, label):
            def call(*a, **kw):
                with (rec.profiled(label) if self._profiling
                      else rec.span(label)):
                    return orig[name](*a, **kw)
            return call

        sah.rkmips_plan = wrap("rkmips_plan", "plan")
        sah.rkmips_execute = wrap("rkmips_execute", "execute")
        self._orig = orig

    def profile(self) -> None:
        """Whole batches, each phase under its own profiler session, for
        ``profile_seconds`` of wall time and until a lane is left to the
        scan (at most 200 batches)."""
        from repro_torch.kernels import ops
        rec, c = self.ctx.rec, self.ctx.rec.counters
        self._profiling = True
        for name in ("tile_steps", "chunks", "lanes", "queries"):
            c["profile." + name] = 0
        for _ in range(200):
            before = _tile_launches(ops)
            res = self._run()
            c["profile.tile_steps"] += _tile_launches(ops) - before
            c["profile.chunks"] += res.funnel.chunks
            c["profile.lanes"] += res.funnel.scan_lanes
            c["profile.queries"] += res.predictions.shape[0]
            _, wall = rec.session_totals()
            if (wall >= float(self.mix["profile_seconds"])
                    and c["profile.lanes"]):
                break

    def release(self) -> None:
        if getattr(self, "_orig", None):
            from repro_torch.core import sah
            for name, fn in self._orig.items():
                setattr(sah, name, fn)
        self.engine = None

    # -- correctness -----------------------------------------------------

    def check(self, limits):
        return judge(self.items, self.users, self.kept, self.k,
                     self.cfg["engine"]["tie_eps"], self.ctx.reference)


def _tile_launches(ops) -> int:
    """Tile steps so far: one ``hamming_nearest`` launch a step under the
    f32 scan, one ``fused_scan`` launch under int8."""
    return ops.launch_counts["hamming_nearest"] + ops.launch_counts[
        "fused_scan"]


def judge(items, users, kept, k, tie_eps, ref, block: int = 64):
    """Compare each kept batch's predictions (qids, pred (b, m) bool)
    with the reference's answers. Returns (checks, failed, info).

    Two numbers are compared, each per million users of the exact
    audiences summed over the batches: ``missed_ppm``, users the
    reference puts in an audience and the answer leaves out, and
    ``extra_ppm``, users the answer adds. A float32 tie (a decision
    within float32 rounding of its threshold, ``ref.tied``) may fall
    either way, so neither is 0 for a sound run; a lower precision moves
    many more decisions. The configuration also guarantees that no user
    is missed but for ties (the sketch's "no" is certified by exact inner
    products): ``missed_untied`` is reported beside them. ``failed``
    counts the queries with a missed user that is no tie."""
    uu = ref.unit_rows(users)
    kth = ref.kth_values(items, uu, k)
    extra = audience = pairs = row0 = 0
    miss_u, miss_q, miss_row = [], [], []
    for qids, pred in kept:
        for lo in range(0, qids.numel(), block):
            q = qids[lo:lo + block]
            truth = ref.reverse_answers(kth, uu, items[q], tie_eps)
            p = pred[lo:lo + block]
            fn = (truth & ~p).nonzero()
            audience += int(truth.sum())
            extra += int((p & ~truth).sum())
            pairs += truth.numel()
            miss_u.append(fn[:, 1])
            miss_q.append(q[fn[:, 0]])
            miss_row.append(row0 + lo + fn[:, 0])
        row0 += qids.numel()
    mu, mq, mr = (torch.cat(x) for x in (miss_u, miss_q, miss_row))
    tie = (ref.tied(items, uu[mu], items[mq], k, tie_eps) if mu.numel()
           else torch.zeros(0, dtype=torch.bool, device=mu.device))
    per = 1e6 / max(audience, 1)
    checks = {"missed_ppm": mu.numel() * per, "extra_ppm": extra * per}
    info = {"queries": row0, "compared_pairs": pairs, "audience": audience,
            "missed": mu.numel(), "missed_untied": int((~tie).sum()),
            "extra": extra}
    return checks, len(set(mr[~tie].tolist())), info
