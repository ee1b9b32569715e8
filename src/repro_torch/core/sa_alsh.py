"""SA-ALSH: the shifting-aware asymmetric LSH index and its counting scan.

Port of ``src/repro/core/sa_alsh.py:53-643`` (the build side, the
RkMIPS decision scan in f32 and int8, the forward kMIPS scan, and the
helpers that fold an artifact's staged-insert delta buffer into both
directions). Items are
sorted by descending norm, cut into norm partitions, SAT-shifted by their
partition's centroid (or QNF-extended, for H2-ALSH) and SRP-hashed into
packed int32 codes. The decision scan walks norm-ordered tiles, picks
each lane's ``n_cand`` nearest rows by Hamming distance, and counts the
exact inner products that beat the lane's threshold, stopping early on
the Cauchy-Schwarz bound ``mu = tile_max_norm * ||u||`` (users are unit).

The reference's ``lax.while_loop``s over tiles (and over the int8 band
passes) are host loops here: one device-to-host sync per tile step and
per band pass.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.core import partitions as _parts
from repro_torch.core import srp as _srp
from repro_torch.core import transforms as _tf
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

SCAN_PRECISIONS = ("f32", "int8")

# Work of the int8 band re-rank in this process, for measurement
# (``chip_smoke.py``): "passes" counts the host loop's passes; "lanes" sums
# the lanes that enter a pass with band rows left, accumulated on the
# device so that counting adds no sync. ``reset_band_counts`` zeroes both;
# serving threads update them under ``_band_lock``.
band_counts: dict = {"passes": 0, "lanes": 0}
_band_lock = threading.Lock()


def reset_band_counts() -> None:
    with _band_lock:
        band_counts.update(passes=0, lanes=0)


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
        transformed = _tf.sat_item_transform(items_sorted,
                                             parts.centroid[pid],
                                             parts.radius[pid])
    elif transform == "qnf":
        # M^2 - ||p||^2 from the sorted norms, as the reference's build
        # does (``qnf_item_transform`` sums the squares instead)
        ext2 = torch.clamp(parts.max_norm[pid] ** 2 - norms_sorted ** 2,
                           min=0.0)
        transformed = torch.cat([items_sorted, torch.sqrt(ext2)[:, None]],
                                dim=-1)
    else:
        raise ValueError(f"unknown transform {transform!r}")

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
                tile: int = 512, transform: str = "sat",
                hash_rows=None) -> SAALSHIndex:
    """Build an SA-ALSH (``transform="sat"``) or H2-ALSH-style (``"qnf"``)
    index. ``proj`` (d+1, n_bits) replaces the projection drawn from
    ``generator`` (the reference draws it from a JAX key, ``srp.py:33``).
    The item codes are one ``srp_hash`` call over all rows;
    ``hash_rows(rows, proj) -> codes`` replaces it (the staged build's
    row-parallel hashing, ``sa_alsh.py:269-282``)."""
    prep = prepare_items(items, b=b, max_partitions=max_partitions,
                         tile=tile, transform=transform)
    if proj is None:
        if generator is None:
            raise ValueError("build_index needs a generator or a proj")
        proj = _srp.make_projection(generator, items.shape[1] + 1, n_bits,
                                    items.device)
    codes = (hash_rows or kops.srp_hash)(prep.transformed.contiguous(), proj)
    return assemble_index(prep, codes, proj)


def user_codes(index: SAALSHIndex, users: torch.Tensor) -> torch.Tensor:
    """SRP codes of user/query rows: sign(u @ proj[:d]). (m, d) -> (m, W)."""
    return kops.srp_hash(users.contiguous(), index.proj[:-1])


def _tile_slice(arr: torch.Tensor, t: int, tile: int) -> torch.Tensor:
    return arr[t * tile:(t + 1) * tile]


def lane_ips(items_t: torch.Tensor, rows: torch.Tensor,
             users: torch.Tensor) -> torch.Tensor:
    """Exact f32 IPs of each lane's tile rows: items_t (tile, d), rows
    (C, s) -> (C, s), by a per-lane elementwise product and row sum.

    The one expression for a gathered re-rank: the f32 scan scores its
    (C, n_cand) candidates with it and the int8 band re-rank its (C, s)
    band rows, so the two paths round a lane's IP identically and their
    counts agree bit for bit (PORT.md); ``merge_delta_topk`` scores the
    staged rows with it too. A lane's IPs never depend on which
    lanes share the chunk (a batched GEMM's blocking may)."""
    return (items_t[rows.long()] * users[:, None, :]).sum(dim=-1)


def _tile_candidates(index: SAALSHIndex, ucodes, users, t: int, *,
                     n_cand: int, scan: str):
    """Exact IPs of tile t's top-``n_cand`` sketch candidates.

    Returns (ips (C, c), valid (C, c) bool, local (C, c) int32 rows in
    the tile); ``scan="exact"`` takes the whole tile (c == tile).

    The reference selects with ``lax.top_k(-dist, n_cand)``, which breaks
    the everywhere-present Hamming ties toward the lower row;
    ``ops.hamming_nearest`` (one kernel launch on the card) gives exactly
    that set in exactly that order.
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
    cand = kops.hamming_nearest(ucodes, codes_t, mask_t, n_cand)
    return lane_ips(items_t, cand, users), mask_t[cand.long()], cand


# Headroom on the quantization error ball (``sa_alsh.py:328-332``): the
# ball bounds the real-arithmetic rounding residual; the extra 1% covers
# the f32 rounding of the dequantized and the exact IP evaluations.
_QERR_SLACK = 1.01


def _tile_beat_int8(index: SAALSHIndex, ucodes, users, unorm, thr,
                    t: int, *, n_cand: int, scan: str) -> torch.Tensor:
    """Per-lane count of tile t's rows that beat ``thr`` under the int8
    screen: bitwise the f32 scan's count (port of ``sa_alsh.py:337-407``).

    Candidates are classified with their dequantized int8 IPs and the
    conservative error ball ``qerr = 0.5 * sqrt(d) * slack * scale *
    ||u||`` (Cauchy-Schwarz on the per-coordinate residual |delta_i| <=
    scale / 2): a definite beat (qips - qerr > thr) counts at once, a
    definite miss (qips + qerr <= thr) drops, and only the band between is
    re-ranked in exact f32, in passes of ``s_slots`` rows per lane. The
    reference's ``lax.while_loop`` over passes is a host loop here: one
    ``left.any()`` sync per pass.
    """
    tile = index.tile
    radius = 0.5 * float(index.dim) ** 0.5 * _QERR_SLACK
    items_t = _tile_slice(index.items, t, tile)
    mask_t = _tile_slice(index.item_mask, t, tile)
    qitems_t = _tile_slice(index.qitems, t, tile)
    qscale_t = _tile_slice(index.qscale, t, tile)
    thr2 = thr[:, None]
    if scan == "exact":
        # Dense screen over the whole tile; the band re-ranks against the
        # same (C, tile) GEMM the f32 exact scan computes.
        qips = (users @ qitems_t.T.to(torch.float32)) * qscale_t[None, :]
        qerr = (radius * qscale_t)[None, :] * unorm[:, None]
        valid = mask_t[None, :]
        definite = valid & (qips - qerr > thr2)
        band = valid & ~definite & (qips + qerr > thr2)
        ips = users @ items_t.T
        return (definite.sum(dim=-1)
                + (band & (ips > thr2)).sum(dim=-1)).to(torch.int32)

    codes_t = _tile_slice(index.codes, t, tile)
    cand, qips = kops.fused_scan(ucodes, codes_t, mask_t, qitems_t,
                                 qscale_t, users, n_cand=n_cand)
    rows = cand.long()
    valid = mask_t[rows]
    qerr = radius * qscale_t[rows] * unorm[:, None]
    definite = valid & (qips - qerr > thr2)
    left = valid & ~definite & (qips + qerr > thr2)
    count = definite.sum(dim=-1).to(torch.int32)
    # Exact re-rank of the band, s_slots rows per lane per pass (one pass
    # in practice: the band is the thin shell |ip - thr| < qerr). Each pass
    # takes each lane's first s_slots band positions in position order, as
    # the reference's top_k over the band flags does.
    s_slots = min(16, n_cand)
    while bool(left.any()):
        with _band_lock:
            band_counts["passes"] += 1
            band_counts["lanes"] = band_counts["lanes"] + left.any(
                dim=-1).sum()
        pos = torch.argsort((~left).to(torch.uint8), dim=-1,
                            stable=True)[:, :s_slots]
        real = left.gather(1, pos)
        eips = lane_ips(items_t, cand.gather(1, pos), users)
        count = count + (real & (eips > thr2)).sum(dim=-1).to(torch.int32)
        left = left.scatter(1, pos, False)
    return count


def check_precision(scan_precision: str) -> None:
    """Refuse an unknown scan precision."""
    if scan_precision not in SCAN_PRECISIONS:
        raise ValueError(f"scan_precision must be one of {SCAN_PRECISIONS},"
                         f" got {scan_precision!r}")


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

    ``scan_precision="int8"`` screens each tile with the fused int8 kernel
    and re-ranks only the band in f32 (``_tile_beat_int8``); its counts,
    and so its decisions and tile walk, are bitwise the f32 scan's.
    """
    check_precision(scan_precision)
    n_tiles = index.tile_max_norm.shape[0]
    n_cand_eff = index.tile if scan == "exact" else n_cand
    ucodes = user_codes(index, users) if scan == "sketch" else None
    thr = taus + eps
    unorm = (torch.linalg.norm(users, dim=-1)
             if scan_precision == "int8" else None)
    count = torch.where(active, init_count, k).to(torch.int32)
    undecided = active & (count < k)
    t = 0
    while t < n_tiles and bool(undecided.any()):
        still = undecided & ~(index.tile_max_norm[t] <= taus)
        if scan_precision == "int8":
            beat = _tile_beat_int8(index, ucodes, users, unorm, thr, t,
                                   n_cand=n_cand_eff, scan=scan)
        else:
            ips, valid, _ = _tile_candidates(index, ucodes, users, t,
                                             n_cand=n_cand_eff, scan=scan)
            beat = ((ips > thr[:, None]) & valid).sum(dim=-1).to(
                torch.int32)
        count = count + torch.where(still, beat, 0)
        undecided = still & (count < k)
        t += 1
    return active & (count < k), t


# ---------------------------------------------------------------------------
# Forward kMIPS.
# ---------------------------------------------------------------------------


def merge_topk(vals: torch.Tensor, ids: torch.Tensor,
               extra_vals: torch.Tensor, extra_ids: torch.Tensor, k: int):
    """Row-wise merge of two candidate sets into one descending top-k
    (port of ``sa_alsh.py:497-511``): (Q, a) and (Q, b) -> (Q, k) each.
    Dead candidates carry ``-inf``. Among equal values the lower position
    of the concatenation ``[vals, extra_vals]`` comes first, as under
    ``lax.top_k``."""
    merged_v = torch.cat([vals, extra_vals], dim=-1)
    merged_i = torch.cat([ids, extra_ids], dim=-1)
    best, pos = kref.topk_stable(merged_v, k)
    return best, merged_i.gather(1, pos)


def merge_delta_topk(vals: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, d_items: torch.Tensor,
                     d_mask: torch.Tensor, k: int, n_base: int):
    """Fold the staged-insert delta buffer into a main-index top-k answer
    (port of ``sa_alsh.py:514-575``).

    vals/ids (Q, k): the main scan's descending top-k; queries (Q, d);
    d_items (cap, d) staged rows, live where d_mask (cap,). Staged row j
    gets id ``n_base + j``; the main answer comes first among equal
    values. Every (query, row) value is a per-pair product and row sum
    (``lane_ips``, the scans' own expression; the reference maps the
    merge per query), so a batch row equals the same query sent alone.

    The reference's int8 merge first drops the rows its quantized twin
    shows cannot beat the k-th value, and scores the rest as here, so its
    answer is this one bit for bit. The port skips that screen, which
    costs a (Q, cap) product of its own.
    """
    cap = d_items.shape[0]
    rows = torch.arange(cap, device=queries.device).expand(
        queries.shape[0], cap)
    d_vals = torch.where(d_mask[None, :], lane_ips(d_items, rows, queries),
                         float("-inf"))
    d_ids = (n_base + rows).to(ids.dtype)
    return merge_topk(vals, ids, d_vals, d_ids, k)


def kmips_topk(index: SAALSHIndex, queries: torch.Tensor, k: int, *,
               n_cand: int = 64, scan: str = "sketch"):
    """Approximate kMIPS (Algorithm 2) for a batch of queries (port of
    ``sa_alsh.py:601-643``). queries (Q, d) need not be unit.

    Returns (vals (Q, k) descending, ids (Q, k) int32 original item rows,
    tiles_visited int). The tile walk stops once every query's k-th best
    value reaches the Cauchy-Schwarz bound ``tile_max_norm[t] * ||q||`` of
    the next tile; the reference's ``lax.while_loop`` is a host loop, one
    sync per tile.
    """
    n_tiles = index.tile_max_norm.shape[0]
    tile = index.tile
    qn = torch.linalg.norm(queries, dim=-1)
    n_cand_eff = tile if scan == "exact" else n_cand
    ucodes = user_codes(index, queries) if scan == "sketch" else None
    nq = queries.shape[0]
    vals = torch.full((nq, k), float("-inf"), device=queries.device)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=queries.device)
    t = 0
    while t < n_tiles and bool(
            (vals[:, -1] < index.tile_max_norm[t] * qn).any()):
        ips, valid, local = _tile_candidates(index, ucodes, queries, t,
                                             n_cand=n_cand_eff, scan=scan)
        ips = torch.where(valid, ips, float("-inf"))
        global_ids = index.item_ids[t * tile + local.long()]
        vals, ids = merge_topk(vals, ids, ips, global_ids, k)
        t += 1
    return vals, ids, t
