"""Published peaks of the card the cells run on, and the least time of a
piece of work under them.

NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit): 3.35 TB/s
of HBM3, 67 TFLOP/s float32 outside the tensor cores (an FMA counts 2),
33.5 T INT32 operations a second. A card set below 700 W runs slower
under load, so a share is stated beside the card's power limit.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
INT32_PER_S = 33.5e12


class Work(NamedTuple):
    """Operations and bytes of a piece of work: float32 operations (an
    FMA counts 2), INT32 operations, and bytes read and written."""

    fp32: float
    int32: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.fp32 + other.fp32, self.int32 + other.int32,
                    self.bytes + other.bytes)

    def __mul__(self, times: float) -> "Work":
        return Work(self.fp32 * times, self.int32 * times,
                    self.bytes * times)


def least_seconds(work: Work) -> tuple[float, str]:
    """The least time the card could take for ``work``: the largest of
    its bytes over the memory's rate and each kind of operation over its
    own peak, with the name of the bound."""
    return max((work.bytes / HBM_BYTES_PER_S, "bytes"),
               (work.fp32 / FP32_PER_S, "fp32"),
               (work.int32 / INT32_PER_S, "int32"))
