"""Entry points of the kernels, dispatched by the device of the tensors.

Twin of ``src/repro/kernels/ops.py:38-78``. A CUDA tensor launches the
hand-written kernel (or the call raises); a CPU tensor takes the plain
PyTorch version in ``ref.py``. There is no fallback between the two and
no switch: the device of the input decides.

``launch_counts`` maps each kernel to the number of launches its wrapper
made in this process; ``reset_launch_counts`` zeroes it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import hamming_scan as _hamming
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import srp_hash as _srp
from repro_torch.kernels._build import launch_counts

__all__ = ["hamming_scores", "launch_counts", "reset_launch_counts",
           "srp_hash"]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 through a (d, B) projection -> (n, B // 32) int32 codes."""
    if _route(x, "srp_hash"):
        return _srp.srp_hash(x, proj)
    return _ref.srp_hash(x, proj)
