"""Catalog layer: patch-resolved point catalogs in memory and on disk."""

from yet_another_wizz_tpu_torch.catalog.catalog import (
    Catalog,
    InconsistentPatchesError,
)
from yet_another_wizz_tpu_torch.catalog.lazy import LazyCatalog
from yet_another_wizz_tpu_torch.catalog.patch import Metadata, Patch

__all__ = [
    "Catalog",
    "InconsistentPatchesError",
    "LazyCatalog",
    "Metadata",
    "Patch",
]
