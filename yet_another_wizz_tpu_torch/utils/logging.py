"""Logging configuration and terminal progress reporting.

Ported from the JAX package's ``utils/logging.py`` (the reference's
``yaw.utils.logging``, yaw/utils/logging.py:48-311): a package logger with
a coloured terminal formatter (3-letter level prefixes), optional plain
file logging, the ``CLIENT`` level of the pipeline's user-facing progress,
an iteration progress indicator with elapsed-time display, an exception
hook that routes crashes through the logger, and a start-up banner
reporting the version and the torch devices.

:func:`profile_trace` wraps a code region in a ``torch.profiler`` trace
(CPU activity, plus CUDA activity when a card is present) and exports it
as a Chrome trace; the port's spans
(:mod:`~yet_another_wizz_tpu_torch.utils.tracing`) lie in it as ``yawt/``
ranges.
"""

from __future__ import annotations

import contextlib
import logging
import sys
from pathlib import Path
from timeit import default_timer
from typing import TYPE_CHECKING

from yet_another_wizz_tpu_torch._version import __version__
from yet_another_wizz_tpu_torch.utils.misc import format_time

if TYPE_CHECKING:
    from collections.abc import Iterable, Iterator
    from io import TextIOBase
    from typing import TypeVar

    T = TypeVar("T")

__all__ = [
    "CLIENT",
    "Indicator",
    "get_logger",
    "init_file_logging",
    "long_num_format",
    "profile_trace",
]

LOGGER_NAME = "yawt_torch"
PACKAGE_LOGGER = "yet_another_wizz_tpu_torch"

CLIENT = logging.INFO + 5
"""Custom level for user-facing CLI progress messages, between INFO and
WARNING: the pipeline's task announcements stay visible at the default
terminal level while an INFO filter still drops the package's internal
chatter. The same number as the JAX package's and the reference's
``CLIENT`` level (yaw/cli/logging.py:71-75)."""


def _register_client_level() -> None:
    """Register the CLIENT level and a ``Logger.client()`` convenience
    (idempotent: imports must not fight over the registration)."""
    if logging.getLevelName(CLIENT) != "CLIENT":
        logging.addLevelName(CLIENT, "CLIENT")

    def client(self, message, *args, **kwargs):
        if self.isEnabledFor(CLIENT):
            self._log(CLIENT, message, args, **kwargs)

    if not hasattr(logging.Logger, "client"):
        logging.Logger.client = client


_register_client_level()

_LEVEL_STYLES = {
    "DBG": "\033[2m",  # dim
    "INF": "",
    "CLI": "\033[34m",  # blue: user-facing CLI progress
    "WRN": "\033[33m",  # yellow
    "ERR": "\033[31m",  # red
    "CRT": "\033[1;31m",  # bold red
}
_RESET = "\033[0m"

FILE_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"
"""Line format of the project log, the JAX package's."""


def long_num_format(num: float) -> str:
    """Format large numbers with a suffix (delegates to utils.misc)."""
    from yet_another_wizz_tpu_torch.utils.misc import format_long_num

    return format_long_num(num)


class TerminalFormatter(logging.Formatter):
    """Compact coloured formatter: ``LVL | message``."""

    def __init__(self, *, pretty: bool = True) -> None:
        super().__init__("%(asctime)s %(shortlevel)s | %(message)s", "%H:%M:%S")
        self.pretty = pretty

    def format(self, record: logging.LogRecord) -> str:
        short = {
            "DEBUG": "DBG", "INFO": "INF", "CLIENT": "CLI",
            "WARNING": "WRN", "ERROR": "ERR", "CRITICAL": "CRT",
        }.get(record.levelname, record.levelname[:3])
        record.shortlevel = short
        text = super().format(record)
        if self.pretty and sys.stderr.isatty():
            style = _LEVEL_STYLES.get(short, "")
            if style:
                text = f"{style}{text}{_RESET}"
        return text


def get_logger(
    level: str | int = "info",
    *,
    stream: TextIOBase | None = None,
    pretty: bool = True,
    capture_exceptions: bool = True,
) -> logging.Logger:
    """Configure and return the package logger with a terminal handler and
    a startup banner."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())

    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(TerminalFormatter(pretty=pretty))
    logger.handlers = [handler]

    # route errors of the framework's own modules through this logger
    logging.getLogger(PACKAGE_LOGGER).setLevel(level)
    logging.getLogger(PACKAGE_LOGGER).handlers = [handler]

    if capture_exceptions:
        def excepthook(exc_type, value, traceback):
            logger.critical(
                "unhandled exception", exc_info=(exc_type, value, traceback)
            )

        sys.excepthook = excepthook

    emit_welcome(logger)
    return logger


def emit_welcome(logger: logging.Logger) -> None:
    """Log the version and the torch devices."""
    import torch

    logger.info("yet_another_wizz_tpu_torch v%s", __version__)
    if torch.cuda.is_available():
        logger.info(
            "torch %s, CUDA device %s, %d device(s)",
            torch.__version__,
            torch.cuda.get_device_name(0),
            torch.cuda.device_count(),
        )
    else:
        logger.info("torch %s, no CUDA device", torch.__version__)


def init_file_logging(path: Path | str, level: str | int = "debug") -> None:
    """Attach a plain-format file handler to the package loggers.

    One project log at a time: a handler attached by an earlier call is
    closed and replaced, so a process that runs several pipelines writes
    each run into its own project's log only."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(FILE_FORMAT))
    handler.setLevel(level)
    handler._yawt_project_log = True
    for name in (LOGGER_NAME, PACKAGE_LOGGER):
        logger = logging.getLogger(name)
        for old in list(logger.handlers):
            if getattr(old, "_yawt_project_log", False):
                logger.removeHandler(old)
                old.close()
        logger.addHandler(handler)
        # the file log must fill even when no terminal handler configured
        # the logger (--quiet pipelines): an unset or stricter logger
        # level would filter records before any handler sees them
        if logger.level == logging.NOTSET or logger.level > level:
            logger.setLevel(level)


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


TRACE_FILE = "trace.json"
"""Name of the Chrome trace :func:`profile_trace` writes."""


@contextlib.contextmanager
def profile_trace(log_dir: Path | str):
    """Capture a ``torch.profiler`` trace of the wrapped region and export
    it as a Chrome trace, ``<log_dir>/trace.json`` (view it in Perfetto or
    ``chrome://tracing``). It records CPU activity, and CUDA activity when
    a card is present, and the port's spans (``yawt/<stage>`` ranges, see
    :mod:`~yet_another_wizz_tpu_torch.utils.tracing`). The profiler is
    yielded, so a caller can read its ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()  # the region's kernels end inside
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))
