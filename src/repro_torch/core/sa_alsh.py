"""SA-ALSH: the shifting-aware asymmetric LSH index and its counting scan.

Port of ``src/repro/core/sa_alsh.py:53-489`` (the build side and the
RkMIPS decision scan; the forward kMIPS scan is a later slice). Items are
sorted by descending norm, cut into norm partitions, SAT-shifted by their
partition's centroid (or QNF-extended, for H2-ALSH) and SRP-hashed into
packed int32 codes. The decision scan walks norm-ordered tiles, picks
each lane's ``n_cand`` nearest rows by Hamming distance, and counts the
exact inner products that beat the lane's threshold, stopping early on
the Cauchy-Schwarz bound ``mu = tile_max_norm * ||u||`` (users are unit).

The reference's ``lax.while_loop`` over tiles is a host loop here: one
device-to-host sync per tile step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import partitions as _parts
from repro_torch.core import srp as _srp
from repro_torch.kernels import ops as kops

BIG_HAMMING = 1 << 30
SCAN_PRECISIONS = ("f32", "int8")


class SAALSHIndex(NamedTuple):
    """Index over items in descending-norm order, padded to a tile multiple.

    Field for field the reference's ``SAALSHIndex`` (``sa_alsh.py:53``):
    items (n_pad, d) f32; item_ids (n_pad,) int32, -1 padding; norms
    (n_pad,) f32; item_mask (n_pad,) bool; codes (n_pad, W) int32 bit
    views; proj (d+1, B) f32; part_id (n_pad,) int32; part_max_norm (T,);
    part_centroid (T, d); part_radius (T,); n_parts () int32;
    tile_max_norm (n_tiles,); qitems (n_pad, d) int8; qscale (n_pad,) f32.
    """

    items: torch.Tensor
    item_ids: torch.Tensor
    norms: torch.Tensor
    item_mask: torch.Tensor
    codes: torch.Tensor
    proj: torch.Tensor
    part_id: torch.Tensor
    part_max_norm: torch.Tensor
    part_centroid: torch.Tensor
    part_radius: torch.Tensor
    n_parts: torch.Tensor
    tile_max_norm: torch.Tensor
    qitems: torch.Tensor
    qscale: torch.Tensor

    @property
    def tile(self) -> int:
        return self.items.shape[0] // self.tile_max_norm.shape[0]

    @property
    def dim(self) -> int:
        return self.items.shape[1]


def _pad_rows(x: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    pad = n_pad - x.shape[0]
    if pad == 0:
        return x
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def _quantize_with_scale(rows: torch.Tensor, scale: torch.Tensor):
    """round(rows / scale) as int8 (half to even); scale 0 gives 0."""
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(rows / safe[:, None]), -127.0, 127.0)
    return q.to(torch.int8)


def quantize_rows(rows: torch.Tensor):
    """Per-row symmetric int8: (qrows, scale), scale = max|row| / 127."""
    scale = rows.abs().amax(dim=-1) / 127.0
    return _quantize_with_scale(rows, scale), scale.to(torch.float32)


def quantize_partitioned(rows: torch.Tensor, part_id: torch.Tensor,
                         max_partitions: int):
    """Per-partition symmetric int8: one scale per norm partition (max
    |coord| in it / 127), broadcast back to (n,) rows."""
    absmax = rows.abs().amax(dim=-1)
    pmax = torch.zeros(max_partitions, dtype=rows.dtype, device=rows.device)
    pmax = pmax.scatter_reduce(0, part_id.long(), absmax, "amax",
                               include_self=False)
    scale = (pmax / 127.0)[part_id.long()]
    return _quantize_with_scale(rows, scale), scale.to(torch.float32)


class PreparedItems(NamedTuple):
    """Item-side build state minus the SRP codes (``sa_alsh.py:155``).
    Row fields are padded to n_pad rows; ``transformed`` (n_pad, d+1) are
    the rows to hash, zero for padding."""

    items: torch.Tensor
    item_ids: torch.Tensor
    norms: torch.Tensor
    item_mask: torch.Tensor
    part_id: torch.Tensor
    part_max_norm: torch.Tensor
    part_centroid: torch.Tensor
    part_radius: torch.Tensor
    n_parts: torch.Tensor
    tile_max_norm: torch.Tensor
    transformed: torch.Tensor
    qitems: torch.Tensor
    qscale: torch.Tensor


def prepare_items(items: torch.Tensor, *, b: float = 0.5,
                  max_partitions: int = 64, tile: int = 512,
                  transform: str = "sat") -> PreparedItems:
    """Norm-sort, partition and transform items (no hashing).
    Port of ``sa_alsh.py:188-242``."""
    n, d = items.shape
    n_pad = -(-n // tile) * tile
    norms = torch.linalg.norm(items, dim=-1)
    order = torch.argsort(-norms, stable=True)
    items_sorted = items[order]
    norms_sorted = norms[order]

    parts = _parts.build_partitions(items_sorted, norms_sorted, b,
                                    max_partitions)
    pid = parts.part_id.long()
    if transform == "sat":
        shifted = items_sorted - parts.centroid[pid]
        ext2 = torch.clamp(parts.radius[pid] ** 2
                           - torch.sum(shifted * shifted, dim=-1), min=0.0)
    elif transform == "qnf":
        shifted = items_sorted
        ext2 = torch.clamp(parts.max_norm[pid] ** 2 - norms_sorted ** 2,
                           min=0.0)
    else:
        raise ValueError(f"unknown transform {transform!r}")
    transformed = torch.cat([shifted, torch.sqrt(ext2)[:, None]], dim=-1)

    item_mask = _pad_rows(torch.ones(n, dtype=torch.bool,
                                     device=items.device), n_pad)
    norms_p = _pad_rows(norms_sorted, n_pad)
    qitems, qscale = quantize_partitioned(items_sorted, parts.part_id,
                                          max_partitions)
    return PreparedItems(
        items=_pad_rows(items_sorted, n_pad),
        item_ids=_pad_rows(order.to(torch.int32), n_pad, fill=-1),
        norms=norms_p,
        item_mask=item_mask,
        part_id=_pad_rows(parts.part_id, n_pad, fill=max_partitions - 1),
        part_max_norm=parts.max_norm,
        part_centroid=parts.centroid,
        part_radius=parts.radius,
        n_parts=parts.n_parts,
        tile_max_norm=norms_p.reshape(-1, tile).amax(dim=-1),
        transformed=_pad_rows(transformed, n_pad),
        qitems=_pad_rows(qitems, n_pad),
        qscale=_pad_rows(qscale, n_pad),
    )


def assemble_index(prep: PreparedItems, codes: torch.Tensor,
                   proj: torch.Tensor) -> SAALSHIndex:
    """Combine prepared item state with its SRP codes."""
    fields = prep._asdict()
    del fields["transformed"]
    return SAALSHIndex(codes=codes, proj=proj, **fields)


def build_index(items: torch.Tensor, generator: torch.Generator | None = None,
                *, proj: torch.Tensor | None = None, b: float = 0.5,
                n_bits: int = 128, max_partitions: int = 64,
                tile: int = 512, transform: str = "sat") -> SAALSHIndex:
    """Build an SA-ALSH (``transform="sat"``) or H2-ALSH-style (``"qnf"``)
    index. ``proj`` (d+1, n_bits) replaces the projection drawn from
    ``generator`` (the reference draws it from a JAX key, ``srp.py:33``).
    The item codes are one ``srp_hash`` call over all rows."""
    prep = prepare_items(items, b=b, max_partitions=max_partitions,
                         tile=tile, transform=transform)
    if proj is None:
        if generator is None:
            raise ValueError("build_index needs a generator or a proj")
        proj = _srp.make_projection(generator, items.shape[1] + 1, n_bits,
                                    items.device)
    codes = kops.srp_hash(prep.transformed.contiguous(), proj)
    return assemble_index(prep, codes, proj)


def user_codes(index: SAALSHIndex, users: torch.Tensor) -> torch.Tensor:
    """SRP codes of user/query rows: sign(u @ proj[:d]). (m, d) -> (m, W)."""
    return kops.srp_hash(users.contiguous(), index.proj[:-1])


def _tile_slice(arr: torch.Tensor, t: int, tile: int) -> torch.Tensor:
    return arr[t * tile:(t + 1) * tile]


def _tile_candidates(index: SAALSHIndex, ucodes, users, t: int, *,
                     n_cand: int, scan: str):
    """Exact IPs of tile t's top-``n_cand`` sketch candidates.

    Returns (ips (C, c), valid (C, c) bool, local (C, c) int32 rows in
    the tile); ``scan="exact"`` takes the whole tile (c == tile).

    The reference selects with ``lax.top_k(-dist, n_cand)``, which breaks
    the everywhere-present Hamming ties toward the lower row. Selecting on
    the unique int64 key ``dist * tile + row`` gives exactly that set in
    exactly that order (``torch.topk`` alone promises neither).
    """
    tile = index.tile
    items_t = _tile_slice(index.items, t, tile)
    mask_t = _tile_slice(index.item_mask, t, tile)
    if scan == "exact":
        ips = users @ items_t.T
        local = torch.arange(tile, dtype=torch.int32,
                             device=users.device).expand(ips.shape)
        return ips, mask_t[None, :].expand(ips.shape), local
    codes_t = _tile_slice(index.codes, t, tile)
    dist = kops.hamming_scores(ucodes, codes_t)
    dist = torch.where(mask_t[None, :], dist, BIG_HAMMING)
    key = dist.to(torch.int64) * tile + torch.arange(tile,
                                                     device=dist.device)
    cand = torch.topk(key, n_cand, dim=-1, largest=False,
                      sorted=True).values % tile
    # Per-lane elementwise product and row sum: a lane's IPs never depend
    # on which lanes share the chunk (a batched GEMM's blocking may).
    ips = (items_t[cand] * users[:, None, :]).sum(dim=-1)
    return ips, mask_t[cand], cand.to(torch.int32)


def check_precision(scan_precision: str) -> None:
    """Refuse a scan precision this slice of the port does not run."""
    if scan_precision not in SCAN_PRECISIONS:
        raise ValueError(f"scan_precision must be one of {SCAN_PRECISIONS},"
                         f" got {scan_precision!r}")
    if scan_precision == "int8":
        raise NotImplementedError(
            "scan_precision='int8' (the fused int8 screen) is ported in the "
            "next slice of the port; use scan_precision='f32'")


def decide_count(index: SAALSHIndex, users: torch.Tensor,
                 taus: torch.Tensor, init_count: torch.Tensor,
                 active: torch.Tensor, k: int, *, n_cand: int = 64,
                 scan: str = "sketch", eps: torch.Tensor | float = 0.0,
                 scan_precision: str = "f32"):
    """RkMIPS decision for a chunk of user lanes against their thresholds.

    Port of ``decide_count_impl`` (``sa_alsh.py:410-489``). users (C, d)
    unit rows; taus (C,) = <u, q>; init_count (C,) items of P' known to
    beat tau; active (C,) lanes that need work; eps a scalar or (C,).
    Lanes are independent, so a chunk may mix queries.

    Returns (is_yes (C,) bool, tiles_visited int). Rule: "no" iff
    #{p : <u, p> > tau + eps} >= k; "yes" when the scan is exhausted or
    the tile bound mu <= tau with the count still below k. The tile loop
    is a host loop, one sync per tile step.
    """
    check_precision(scan_precision)
    n_tiles = index.tile_max_norm.shape[0]
    n_cand_eff = index.tile if scan == "exact" else n_cand
    ucodes = user_codes(index, users) if scan == "sketch" else None
    thr = taus + eps
    count = torch.where(active, init_count, k).to(torch.int32)
    undecided = active & (count < k)
    t = 0
    while t < n_tiles and bool(undecided.any()):
        still = undecided & ~(index.tile_max_norm[t] <= taus)
        ips, valid, _ = _tile_candidates(index, ucodes, users, t,
                                         n_cand=n_cand_eff, scan=scan)
        beat = ((ips > thr[:, None]) & valid).sum(dim=-1).to(torch.int32)
        count = count + torch.where(still, beat, 0)
        undecided = still & (count < k)
        t += 1
    return active & (count < k), t
