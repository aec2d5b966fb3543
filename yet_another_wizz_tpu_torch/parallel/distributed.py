"""Process coordination for root-only work.

Single-process only: multi-process jobs (``torch.distributed``) come with
the port of the JAX package's ``parallel`` layer.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from collections.abc import Callable
    from typing import Any

__all__ = [
    "run_on_root",
]


def run_on_root(func: Callable, *args: Any, **kwargs: Any) -> Any:
    """Execute ``func(*args, **kwargs)`` on the root process and return its
    result. With one process, that process is the root."""
    return func(*args, **kwargs)
