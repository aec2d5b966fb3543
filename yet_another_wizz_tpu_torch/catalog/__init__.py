"""Catalog layer: patch-resolved point catalogs in memory."""

from yet_another_wizz_tpu_torch.catalog.catalog import (
    Catalog,
    InconsistentPatchesError,
)
from yet_another_wizz_tpu_torch.catalog.patch import Metadata

__all__ = [
    "Catalog",
    "InconsistentPatchesError",
    "Metadata",
]
