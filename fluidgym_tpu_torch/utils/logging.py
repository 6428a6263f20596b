"""Logging setup (counterpart of ``fluidgym_tpu/utils/logging.py``): file
and console handlers, per-class loggers, and optional stdout / stderr
capture into the log file (``StreamCapture``)."""

from __future__ import annotations

import logging
import sys
from pathlib import Path

__all__ = ["setup_logging", "get_logger", "StreamCapture"]

_FORMAT = "[%(asctime)s][%(name)s:%(levelname)s] %(message)s"


class StreamCapture:
    """Tee a stream (stdout/stderr) into a file while passing it through:
    everything printed, including output from libraries that bypass
    ``logging``, lands in the run's log file.  Restore with :meth:`close`."""

    def __init__(self, stream, file_path: str | Path):
        self._stream = stream
        self._file = open(file_path, "a", buffering=1)

    def write(self, data) -> int:
        self._file.write(data)
        return self._stream.write(data)

    def flush(self) -> None:
        self._file.flush()
        self._stream.flush()

    def isatty(self) -> bool:
        return bool(getattr(self._stream, "isatty", lambda: False)())

    @property
    def stream(self):
        """The wrapped original stream."""
        return self._stream

    def close(self) -> None:
        """Close the capture file (the wrapped stream stays open)."""
        self._file.close()

    def __getattr__(self, name):
        return getattr(self._stream, name)


def setup_logging(log_dir: str | Path | None = None, level=logging.INFO,
                  filename: str = "fluidgym_tpu.log",
                  capture_streams: bool = False) -> None:
    """Configure root logging with console + optional file handler.

    ``capture_streams=True`` additionally tees ``sys.stdout``/``sys.stderr``
    into ``<log_dir>/<filename>.captured`` (requires ``log_dir``)."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_dir / filename))
        if capture_streams:
            capture_path = log_dir / (filename + ".captured")
            if not isinstance(sys.stdout, StreamCapture):
                sys.stdout = StreamCapture(sys.stdout, capture_path)
            if not isinstance(sys.stderr, StreamCapture):
                sys.stderr = StreamCapture(sys.stderr, capture_path)
    logging.basicConfig(level=level, format=_FORMAT, handlers=handlers,
                        force=True)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
