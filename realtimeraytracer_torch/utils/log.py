"""Leveled logger with millisecond timestamps and a swappable sink.

The port's own copy of realtimeraytracer_tpu/utils/log.py (the reference's
``core::log``, src/core/log.cppm:11-85): the level comes from
RTRT_LOG_LEVEL (default "info") or ``set_level``, messages are str.format
strings, and the sink is a callable (default: stderr).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable

_LEVELS = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4, "critical": 5}

_level = _LEVELS.get(os.environ.get("RTRT_LOG_LEVEL", "info").lower(), 2)
_t0 = time.monotonic()

Sink = Callable[[str], None]
_sink: Sink = lambda msg: print(msg, file=sys.stderr)  # noqa: E731


def set_level(name: str) -> None:
    global _level
    _level = _LEVELS[name.lower()]


def set_sink(sink: Sink) -> None:
    global _sink
    _sink = sink


def _log(level: str, fmt: str, *args, **kwargs) -> None:
    if _LEVELS[level] < _level:
        return
    ms = int((time.monotonic() - _t0) * 1000)
    msg = fmt.format(*args, **kwargs) if (args or kwargs) else fmt
    _sink(f"[{ms:8d}ms] [{level:<8s}] {msg}")


def trace(fmt: str, *a, **k) -> None:
    _log("trace", fmt, *a, **k)


def debug(fmt: str, *a, **k) -> None:
    _log("debug", fmt, *a, **k)


def info(fmt: str, *a, **k) -> None:
    _log("info", fmt, *a, **k)


def warn(fmt: str, *a, **k) -> None:
    _log("warn", fmt, *a, **k)


def error(fmt: str, *a, **k) -> None:
    _log("error", fmt, *a, **k)


def critical(fmt: str, *a, **k) -> None:
    _log("critical", fmt, *a, **k)
