"""Terminal progress reporting.

Ported from the JAX package's ``utils/logging.py`` as far as the port uses
it: the :class:`Indicator` that ``progress=True`` prints (the reference's
``yaw.utils.logging``, yaw/utils/logging.py:48-311). The logger set-up
and the CLI levels come with the command line (ROADMAP M7.1).
"""

from __future__ import annotations

import sys
from timeit import default_timer
from typing import TYPE_CHECKING

from yet_another_wizz_tpu_torch.utils.misc import format_time

if TYPE_CHECKING:
    from collections.abc import Iterable, Iterator
    from io import TextIOBase
    from typing import TypeVar

    T = TypeVar("T")

__all__ = [
    "Indicator",
]


class Indicator:
    """Progress indicator over an iterable: writes
    ``processed i/N (x%) t=MmSS.SSs`` to the terminal."""

    __slots__ = ("iterable", "total", "min_interval", "stream", "template")

    def __init__(
        self,
        iterable: Iterable[T],
        total: int | None = None,
        *,
        min_interval: float = 0.02,
        stream: TextIOBase | None = None,
    ) -> None:
        self.iterable = iterable
        self.total = total if total is not None else len(iterable)
        self.min_interval = min_interval
        self.stream = stream or sys.stderr
        digits = len(str(self.total))
        self.template = f"processed %{digits}d/{self.total} (%.0f%%) t=%s\r"

    def __iter__(self) -> Iterator[T]:
        start = last = default_timer()
        self._write(0, start, start)
        for count, item in enumerate(self.iterable, 1):
            yield item
            now = default_timer()
            if (now - last) > self.min_interval:
                last = now
                self._write(count, start, now)
        end = default_timer()
        self._write(self.total, start, end)
        self.stream.write("\n")
        self.stream.flush()

    def _write(self, count: int, start: float, now: float) -> None:
        fraction = count / self.total if self.total else 1.0
        self.stream.write(
            self.template % (count, 100 * fraction, format_time(now - start))
        )
        self.stream.flush()
