"""Arch configs the port runs (twin of ``repro.configs``)."""

from repro_torch.configs.base import (ArchSpec, ShapeSpec,  # noqa: F401
                                      all_archs, get, register)
