"""Process-level helpers. Only single-process execution exists so far."""

from yet_another_wizz_tpu_torch.parallel.distributed import run_on_root

__all__ = [
    "run_on_root",
]
