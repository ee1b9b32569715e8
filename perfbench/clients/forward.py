"""Forward k-MIPS cells: closed loop, one client, batches of users whose
top-k items ``RkMIPSEngine.kmips`` returns.

Set-up makes the configuration's catalogue on the device from its
``catalogue_seed``, builds the forward index alone (``build(items,
None, ...)``, its random draws from ``index_seed``) and runs one batch
of the cell's shape. A sample of the window's batches, drawn from the seed
before the window opens (each batch kept with chance ``1 / keep_every``,
the first always), keeps its user rows and answers on the device; once
the window has closed every kept answer is judged against the plain
reference (``judge``): its values and which items it holds. In the traced run, one more series of ``profile_batches``
batches runs under one profiler session.
"""

from __future__ import annotations

import torch

from perfbench.data import synthetic
from perfbench.harness import traffic

UNIT = "users"


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.k = int(self.mix["k"])
        self.kept: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self._i = 0

    def setup(self) -> None:
        self.prepare()
        self.build()
        self._run()                          # the warm batch, judged
        if self.ctx.trace:
            self.ctx.rec.warm_profiler()

    def prepare(self) -> None:
        """The catalogue, the user walk and the sample of judged batches,
        all from the configuration and the seed: no program call."""
        ctx, cfg = self.ctx, self.cfg
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(cfg["catalogue_seed"])
        self.items, self.users = synthetic.recommendation_data(
            gen, cfg["n_items"], cfg["m_users"], cfg["d"])
        self.walk = traffic.UserWalk(cfg["m_users"], int(self.mix["batch"]),
                                     ctx.seed)
        keep_gen = torch.Generator()
        keep_gen.manual_seed(ctx.seed)
        # which batches are judged, drawn before the window opens
        self._keep = torch.rand(1 << 16, generator=keep_gen) < (
            1.0 / int(self.mix["keep_every"]))
        self._keep[0] = True

    def build(self) -> None:
        """The forward index alone, its random draws from the
        configuration's ``index_seed``: the sketch's recall depends on its
        projection, so every run serves the one index."""
        from repro_torch.engine import RkMIPSEngine
        from repro_torch.engine.config import EngineConfig
        build_gen = torch.Generator()
        build_gen.manual_seed(self.cfg["index_seed"])
        self.engine = RkMIPSEngine(EngineConfig(**self.cfg["engine"]),
                                   device=self.ctx.device)
        self.engine.build(self.items, None, build_gen)
        self.ctx.rec.counters["build_seconds"] = self.engine.build_seconds

    def _run(self):
        uids = self.walk.next().to(self.ctx.device)
        res = self.engine.kmips(self.users[uids], self.k)
        if self._i < self._keep.numel() and bool(self._keep[self._i]):
            self.kept.append((uids, res.ids, res.values))
        self._i += 1
        return res

    def batch(self) -> int:
        res = self._run()
        if self.ctx.trace:
            self.ctx.rec.add("tiles", res.tiles_visited)
            self.ctx.rec.add("batches", 1)
        return res.ids.shape[0]

    def may_end(self) -> bool:
        """Every batch does about the same work: the window may close
        after any."""
        return True

    def profile(self) -> None:
        rec, n = self.ctx.rec, int(self.mix["profile_batches"])
        tiles = 0
        with rec.profiled("kmips"):
            for _ in range(n):
                tiles += self._run().tiles_visited
        rec.counters["profile.tile_steps"] = tiles
        rec.counters["profile.batches"] = n
        rec.counters["profile.queries"] = n * int(self.mix["batch"])

    def release(self) -> None:
        self.engine = None

    def check(self, limits):
        return judge(self.items, self.users, self.kept, self.k,
                     self.ctx.reference, limits)


def judge(items, users, kept, k, ref, limits):
    """Compare each kept batch's answers (uids, ids (b, k), values (b, k))
    with the reference. Returns (checks, failed, info).

    Two numbers are compared. ``value_err``: over every returned slot,
    the gap between the value the program returned and the item's inner
    product with the user in float64, over ||u|| ||p||; a slot whose id
    is out of range or repeated in its row, or whose value rises along
    the row, reads 1. ``recall_miss``: the share of the exact top-k
    (float32, TF32 off) that the answers leave out, over every returned
    slot of every kept batch. The sketch's top-k is approximate, so a
    sound run misses a few items; a wrong candidate selection misses most
    of them. ``failed`` counts the users whose values read over their
    limit, and, where ``recall_miss`` reads over its own, the users who
    miss more of their top-k than it allows."""
    n = items.shape[0]
    inorm = torch.linalg.norm(items.double(), dim=-1)
    worst, users_n, hits, total = 0.0, 0, 0, 0
    bad_value, row_hits = [], []
    for uids, ids, vals in kept:
        u = users[uids]
        ids64 = ids.long()
        valid = (ids64 >= 0) & (ids64 < n)
        safe = torch.where(valid, ids64, 0)
        srt = torch.sort(safe, dim=-1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        rising = torch.zeros_like(valid)
        rising[:, 1:] = vals[:, 1:] > vals[:, :-1]
        want = ref.pair_values(items, u, safe)
        scale = (torch.linalg.norm(u.double(), dim=-1)[:, None]
                 * inorm[safe]).clamp_min(1e-300)
        err = (vals.double() - want).abs() / scale
        bad_slot = ~valid | rising | dup.any(-1, keepdim=True)
        err = torch.where(bad_slot | ~torch.isfinite(err),
                          torch.ones_like(err), err)
        row_err = err.amax(-1)
        worst = max(worst, float(row_err.max()))
        bad_value.append(row_err > limits["value_err"])
        _, exact = ref.topk(items, u, k)
        hit = ((ids64[:, :, None] == exact[:, None, :]).any(-1)
               & valid).sum(-1)
        row_hits.append(hit)
        hits += int(hit.sum())
        total += ids64.numel()
        users_n += uids.numel()
    # every run keeps its warm batch, so ``kept`` is never empty
    checks = {"value_err": worst, "recall_miss": 1.0 - hits / total}
    failed = torch.cat(bad_value)
    if checks["recall_miss"] > limits["recall_miss"]:
        row_miss = 1.0 - torch.cat(row_hits).double() / k
        failed = failed | (row_miss > limits["recall_miss"])
    info = {"compared_users": users_n, "judged_batches": len(kept)}
    return checks, int(failed.sum()), info
