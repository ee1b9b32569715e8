"""Sign Random Projection (SimHash) sketches, bit-packed for Hamming scans.

Port of ``src/repro/core/srp.py``. For B independent SRP bits,
E[hamming(code(p), code(u))] = B * theta(p, u) / pi, so ranking items by
the Hamming distance of their packed codes ranks them by estimated angle.
Codes are 32 bits per int32 word (bit views of the reference's uint32).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

_BITS_PER_WORD = 32


def make_projection(generator: torch.Generator, dim: int, n_bits: int,
                    device) -> torch.Tensor:
    """Gaussian projection (dim, n_bits), entries ~ N(0, 1).

    Drawn from ``generator`` (a CPU generator) and then moved to
    ``device``, so one seed gives one projection on every device. Torch
    cannot replay ``jax.random`` (``srp.py:33``): callers that must match
    the reference pass its projection in instead.
    """
    if n_bits % _BITS_PER_WORD != 0:
        raise ValueError(f"n_bits must be a multiple of 32, got {n_bits}")
    return torch.randn(dim, n_bits, generator=generator,
                       dtype=torch.float32).to(device)


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """Pack a boolean sign matrix (n, B) into int32 codes (n, B // 32)."""
    return _ref.pack_signs(signs)


def srp_codes(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """SRP codes of the rows of x (n, dim) under proj (dim, B) -> int32
    (n, B // 32): the reference's ``pack_signs(x @ proj >= 0)``, one
    product and the plain packing (the build's codes go through the
    ``srp_hash`` kernel instead)."""
    return pack_signs(x @ proj >= 0.0)


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance: (na, W) x (nb, W) int32 -> (na, nb)."""
    return _ref.hamming_scores(a, b)
