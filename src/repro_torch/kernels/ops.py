"""Entry points of the kernels, dispatched by the device of the tensors.

Twin of ``src/repro/kernels/ops.py:30-116``. A CUDA tensor launches the
hand-written kernel (or the call raises); a CPU tensor takes the plain
PyTorch version in ``ref.py``. There is no fallback between the two and
no switch: the device of the input decides.

``launch_counts`` maps each kernel to the number of launches its wrapper
made in this process; ``reset_launch_counts`` zeroes it.
"""

from __future__ import annotations

import torch

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


def _route(t: torch.Tensor, op: str) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {t.device}")


def hamming_scores(query_codes: torch.Tensor,
                   item_codes: torch.Tensor) -> torch.Tensor:
    """(q, W) x (n, W) int32 codes -> (q, n) int32 Hamming distances."""
    if _route(query_codes, "hamming_scores"):
        return _hamming.hamming_scores(query_codes, item_codes)
    return _ref.hamming_scores(query_codes, item_codes)


def hamming_nearest(ucodes: torch.Tensor, item_codes: torch.Tensor,
                    item_mask: torch.Tensor, n_cand: int) -> torch.Tensor:
    """Each lane's ``n_cand`` nearest tile rows by Hamming distance: (C, W)
    x (T, W) int32 codes with a (T,) mask -> (C, n_cand) int32 rows,
    ascending, masked rows behind every live row, the lower row first on
    ties. Kernel and plain version agree exactly."""
    if _route(ucodes, "hamming_nearest"):
        return _hamming.hamming_nearest(ucodes, item_codes, item_mask, n_cand)
    return _ref.hamming_nearest(ucodes, item_codes, item_mask, n_cand)


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 through a (d, B) projection -> (n, B // 32) int32 codes.
    Kernel and plain version agree bit for bit."""
    if _route(x, "srp_hash"):
        return _srp.srp_hash(x, proj)
    return _ref.srp_hash(x, proj)


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
    return _ref.fused_scan(ucodes, item_codes, item_mask, qitems, qscale,
                           users, n_cand)


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
    return _ref.ip_topk(queries, items, k)


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
    return _ref.flash_attention(q, k, v, causal=causal)
