"""The one traffic generator: it turns a mix's parameters
(``traffic/<mix>.json``) and the run's seed into the rows each batch
sends. Every draw comes from a CPU generator seeded with the run's seed,
so the same seed sends the same batches in the same order on every host.

Mix keys read here:
  batch        rows a batch sends
  norm_rank    [lo, hi): reverse queries are the items whose rank by
               descending norm lies in [lo * n, hi * n) (the paper draws
               its queries from the item matrix), the pool cut to a whole
               number of batches; a pass sends the whole pool once, in
               batches of new items drawn without replacement along a
               fresh seeded permutation
  (none)       forward batches walk one seeded permutation of all users
               in order, wrapping at its end

So every seed sends the same queries in another order, and a window of
whole passes does the same work whatever its seed.
"""

from __future__ import annotations

import torch


def _generator(seed: int, stream: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def norm_pool(items: torch.Tensor, norm_rank, batch: int) -> torch.Tensor:
    """Item rows (int64) whose rank by descending norm (stable: the lower
    row first among equal norms) lies in [lo * n, hi * n), the first of
    them in rank order cut to a multiple of ``batch``."""
    n = items.shape[0]
    lo, hi = int(n * norm_rank[0]), int(n * norm_rank[1])
    hi = lo + (hi - lo) // batch * batch
    if not 0 <= lo < hi <= n:
        raise ValueError(f"norm_rank {norm_rank} holds no batch of {batch} "
                         f"of {n} items")
    order = torch.argsort(-torch.linalg.norm(items, dim=-1), stable=True)
    return order[lo:hi].cpu()


class ItemDraws:
    """Passes over the pool, each a seeded permutation of it sent in
    batches of ``batch`` rows (the pool is a whole number of batches)."""

    def __init__(self, pool: torch.Tensor, batch: int, seed: int,
                 stream: int = 1):
        if pool.numel() % batch:
            raise ValueError(f"the pool's {pool.numel()} items are not a "
                             f"whole number of batches of {batch}")
        self.pool, self.batch = pool, batch
        self._gen = _generator(seed, stream)
        self._left = torch.empty(0, dtype=torch.int64)

    def next(self) -> torch.Tensor:
        if not self._left.numel():
            self._left = self.pool[torch.randperm(self.pool.numel(),
                                                  generator=self._gen)]
        out, self._left = self._left[:self.batch], self._left[self.batch:]
        return out

    @property
    def at_pass_end(self) -> bool:
        """Whether the batches drawn so far make whole passes."""
        return not self._left.numel()


class UserWalk:
    """Batches of ``batch`` users along one seeded permutation of the
    ``m`` users, wrapping at its end."""

    def __init__(self, m: int, batch: int, seed: int):
        if batch > m:
            raise ValueError(f"batch {batch} exceeds the {m} users")
        self.perm = torch.randperm(m, generator=_generator(seed, 2))
        self.batch, self._at = batch, 0

    def next(self) -> torch.Tensor:
        m = self.perm.numel()
        idx = (self._at + torch.arange(self.batch)) % m
        self._at = (self._at + self.batch) % m
        return self.perm[idx]
