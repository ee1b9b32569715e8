"""Norm-range partitioning of item vectors (SA-ALSH indexing, Algorithm 1).

Port of ``src/repro/core/partitions.py:43-92``. Items sorted by
descending norm are cut greedily into ranges (b*M_j, M_j], M_j the first
(largest) norm of partition j, with at most ``max_partitions`` ranges.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NormPartitions(NamedTuple):
    """Partition structure over items sorted by descending norm (padded to
    ``max_partitions`` = T entries).

    part_id (n,) int32, n_parts () int32, start (T,) int32, size (T,)
    int32, max_norm (T,) f32 (0 padding), centroid (T, d) f32, radius
    (T,) f32.
    """

    part_id: torch.Tensor
    n_parts: torch.Tensor
    start: torch.Tensor
    size: torch.Tensor
    max_norm: torch.Tensor
    centroid: torch.Tensor
    radius: torch.Tensor


def assign_partitions(sorted_norms: torch.Tensor, b: float,
                      max_partitions: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy norm cut: sorted_norms (n,) descending -> (part_id, n_parts).

    The reference scans item by item (``lax.scan``): item i opens a new
    partition when ``norm_i <= b * cur_max`` in float32, and cur_max
    becomes norm_i. On descending norms the next opening after one at
    position s is the first i > s with ``norm_i <= b * norm_s``, a
    ``searchsorted`` over the negated norms. So this takes one host step
    per partition, at most ``max_partitions - 1`` (the id clamps there and
    later openings change nothing). The very first item is tested against
    itself, as in the reference.
    """
    n = sorted_norms.shape[0]
    neg = -sorted_norms
    starts = []
    lo, cur_max = 0, sorted_norms[0]
    while len(starts) < max_partitions - 1 and lo < n:
        thr = b * cur_max                     # float32, as the reference
        i = lo + int(torch.searchsorted(neg[lo:], -thr))
        if i >= n:
            break
        starts.append(i)
        lo, cur_max = i + 1, sorted_norms[i]
    opened = torch.zeros(n, dtype=torch.int32, device=sorted_norms.device)
    if starts:
        opened[torch.tensor(starts, device=sorted_norms.device)] = 1
    part_id = torch.cumsum(opened, 0, dtype=torch.int32)
    return part_id, torch.tensor(len(starts) + 1, dtype=torch.int32,
                                 device=sorted_norms.device)


def _segment_max(values: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Max of ``values`` per segment; empty segments hold 0."""
    out = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg.long(), values, "amax",
                              include_self=False)


def build_partitions(items_sorted: torch.Tensor, sorted_norms: torch.Tensor,
                     b: float, max_partitions: int) -> NormPartitions:
    """Full partition structure for items sorted by descending norm."""
    n, d = items_sorted.shape
    dev = items_sorted.device
    part_id, n_parts = assign_partitions(sorted_norms, b, max_partitions)
    pid = part_id.long()

    size = torch.bincount(pid, minlength=max_partitions).to(torch.int32)
    start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum(size, 0, dtype=torch.int32)[:-1]])
    max_norm = _segment_max(sorted_norms, part_id, max_partitions)
    max_norm = torch.where(size > 0, max_norm, 0.0)

    # Partitions are contiguous runs of the sorted rows: sum each run. Not
    # index_add_, which adds with atomics in no fixed order on the card, so
    # the centroids (hence every item code) would change from run to run.
    sums = torch.stack([items_sorted[s:s + z].sum(dim=0) for s, z in
                        zip(start.tolist(), size.tolist())])
    centroid = sums / torch.clamp(size.to(torch.float32), min=1.0)[:, None]
    diff = items_sorted - centroid[pid]
    d2 = torch.sum(diff * diff, dim=-1)
    radius2 = _segment_max(d2, part_id, max_partitions)
    radius = torch.sqrt(torch.where(size > 0, radius2, 0.0))

    return NormPartitions(part_id=part_id, n_parts=n_parts, start=start,
                          size=size, max_norm=max_norm, centroid=centroid,
                          radius=radius)
