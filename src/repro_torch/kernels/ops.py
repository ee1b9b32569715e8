"""Entry points of the kernels, dispatched by the device of the tensors.

Twin of ``src/repro/kernels/ops.py:30-116``. A CUDA tensor launches the
hand-written kernel (or the call raises); a CPU tensor takes the plain
PyTorch version in ``ref.py``; a tensor on the meta device, where the dry
run traces a cell's step with no memory (``launch/dryrun.py``), takes the
kernel's op ``torch.ops.repro_torch.<name>``: one op that allocates the
kernel's outputs and nothing else, whose FLOPs (``torch.utils.
flop_counter``'s registry) are the kernel's own work. There is no
fallback between the routes and no switch: the device of the input
decides.

``launch_counts`` maps each kernel to the number of launches its wrapper
made in this process; ``reset_launch_counts`` zeroes it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_scan as _fused
from repro_torch.kernels import hamming_scan as _hamming
from repro_torch.kernels import ip_topk as _ip_topk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import srp_hash as _srp
from repro_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["flash_attention", "fused_scan", "hamming_nearest",
           "hamming_scores", "ip_topk", "launch_counts",
           "reset_launch_counts", "srp_hash"]


# -- the kernels as ops of the meta device ---------------------------------

_LIB = torch.library.Library("repro_torch", "DEF")


def _meta_op(schema: str, outputs, flops=None) -> None:
    """Define ``torch.ops.repro_torch.<name>`` by ``schema`` with
    ``outputs`` (the kernel's outputs, empty) as its only implementation,
    on the Meta key, and ``flops`` (of the arguments' shapes) as its
    FLOPs."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, outputs, "Meta")
    if flops is not None:
        register_flop_formula(getattr(torch.ops.repro_torch, name))(flops)


def _int32(t: torch.Tensor, *shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=t.device)


_meta_op("hamming_scores(Tensor query_codes, Tensor item_codes) -> Tensor",
         lambda q, n: _int32(q, q.shape[0], n.shape[0]))
_meta_op("hamming_nearest(Tensor ucodes, Tensor item_codes, "
         "Tensor item_mask, int n_cand) -> Tensor",
         lambda u, n, m, c: _int32(u, u.shape[0], c))
_meta_op("srp_hash(Tensor x, Tensor proj) -> Tensor",
         lambda x, p: _int32(x, x.shape[0], p.shape[1] // 32),
         lambda x, p, out_shape=None: 2 * x[0] * x[1] * p[1])
_meta_op("fused_scan(Tensor ucodes, Tensor item_codes, Tensor item_mask, "
         "Tensor qitems, Tensor qscale, Tensor users, int n_cand) "
         "-> (Tensor, Tensor)",
         lambda u, n, m, qi, qs, us, c: (
             _int32(u, u.shape[0], c),
             torch.empty(u.shape[0], c, device=u.device)),
         # the dequantized inner products of the candidates
         lambda u, n, m, qi, qs, us, c, out_shape=None: 2 * us[0] * c * qi[1])
_meta_op("ip_topk(Tensor queries, Tensor items, int k) -> (Tensor, Tensor)",
         lambda q, n, k: (torch.empty(q.shape[0], k, device=q.device),
                          _int32(q, q.shape[0], k)),
         lambda q, n, k, out_shape=None: 2 * q[0] * n[0] * q[1])
_meta_op("flash_attention(Tensor q, Tensor k, Tensor v, bool causal=True) "
         "-> Tensor",
         lambda q, k, v, causal=True: torch.empty_like(q),
         # QK^T and PV over the (query, key) pairs the kernel visits: below
         # the diagonal when causal
         lambda q, k, v, causal=True, out_shape=None: (
             4 * q[0] * q[1] * q[3]
             * (q[2] * (q[2] + 1) // 2 if causal else q[2] * k[2])))


def _route(t: torch.Tensor, op: str) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU) and
    the kernel's op (meta)."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{op}: no kernel for device {t.device}")


def _plain(t: torch.Tensor, name: str):
    """Kernel ``name`` off the card, for ``t``'s device: ``ref.py``'s plain
    version on the CPU, the kernel's op on the meta device."""
    return getattr(torch.ops.repro_torch if t.is_meta else _ref, name)


def hamming_scores(query_codes: torch.Tensor,
                   item_codes: torch.Tensor) -> torch.Tensor:
    """(q, W) x (n, W) int32 codes -> (q, n) int32 Hamming distances."""
    if _route(query_codes, "hamming_scores"):
        return _hamming.hamming_scores(query_codes, item_codes)
    return _plain(query_codes, "hamming_scores")(query_codes, item_codes)


def hamming_nearest(ucodes: torch.Tensor, item_codes: torch.Tensor,
                    item_mask: torch.Tensor, n_cand: int) -> torch.Tensor:
    """Each lane's ``n_cand`` nearest tile rows by Hamming distance: (C, W)
    x (T, W) int32 codes with a (T,) mask -> (C, n_cand) int32 rows,
    ascending, masked rows behind every live row, the lower row first on
    ties. Kernel and plain version agree exactly."""
    if _route(ucodes, "hamming_nearest"):
        return _hamming.hamming_nearest(ucodes, item_codes, item_mask, n_cand)
    return _plain(ucodes, "hamming_nearest")(ucodes, item_codes, item_mask,
                                             n_cand)


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 through a (d, B) projection -> (n, B // 32) int32 codes.
    Kernel and plain version agree bit for bit."""
    if _route(x, "srp_hash"):
        return _srp.srp_hash(x, proj)
    return _plain(x, "srp_hash")(x, proj)


def fused_scan(ucodes: torch.Tensor, item_codes: torch.Tensor,
               item_mask: torch.Tensor, qitems: torch.Tensor,
               qscale: torch.Tensor, users: torch.Tensor, *, n_cand: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hamming filter + top-``n_cand`` + dequantized int8 IP per lane:
    (C, W) x (T, W) int32 codes with a (T,) mask, (T, d) int8 rows and
    (T,) scales, (C, d) users -> (cand (C, n_cand) int32, qips (C, n_cand)
    f32). Kernel and plain version agree bit for bit."""
    if _route(users, "fused_scan"):
        return _fused.fused_scan(ucodes, item_codes, item_mask, qitems,
                                 qscale, users, n_cand=n_cand)
    return _plain(users, "fused_scan")(ucodes, item_codes, item_mask,
                                       qitems, qscale, users, n_cand)


def ip_topk(queries: torch.Tensor, items: torch.Tensor,
            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products: (q, d) x (n, d) f32 -> (vals (q, k)
    descending, ids (q, k) int32), the lower id first among equal values.

    On CUDA the kernel reduces each split of the items (a range of whole
    tiles) to its top-k and ``ref.merge_topk`` merges the splits with a
    stable descending sort (the reference's ``ops._merge_topk``). Unlike
    the reference, which takes its Pallas kernel only when ``n`` is a
    multiple of its block, the kernel runs for every n: it masks the tail
    tile itself."""
    if _route(queries, "ip_topk"):
        return _ref.merge_topk(*_ip_topk.ip_topk_tiles(queries, items, k), k)
    return _plain(queries, "ip_topk")(queries, items, k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Fused attention, causal by default: q (B, H, S, Dh) and k/v (B,
    Hkv, S, Dh) with H % Hkv == 0 (query head h reads KV head
    h // (H // Hkv); Hkv = H is the reference's layout), bf16 or float32
    -> (B, H, S, Dh) in q's dtype. On CUDA the hand-written kernels (any
    S, Dh <= 128, contiguous inputs; the route is picked by shape, see
    ``kernels/flash_attention.py``); on the CPU the O(S^2)-memory plain
    version, for smoke-scale shapes (the transformer's default
    ``attn_impl`` stays ``"chunked"``).

    The kernel has no backward, as the reference's Pallas kernel has no
    VJP: on CUDA a call that autograd would record (grad enabled and an
    input requiring grad) raises rather than return an output cut off
    from the graph. The plain version stays differentiable."""
    if _route(q, "flash_attention"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise RuntimeError(
                "flash_attention: the CUDA kernel has no backward; train "
                "with attn_impl='chunked', or call it under torch.no_grad()")
        return _flash.flash_attention(q, k, v, causal=causal)
    return _plain(q, "flash_attention")(q, k, v, causal=causal)
