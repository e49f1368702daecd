"""CHECK helpers and a warning logger.

Counterpart of ``pslite_tpu/utils/logging.py`` (the reference's dmlc
mini-glog and ``PS_VLOG``): ``check``, ``check_eq``, ``warning``,
``fatal_log``, and ``vlog`` gated by ``PS_VERBOSE`` (1 logs
connection-level events, 2 every message).
"""

from __future__ import annotations

import logging
import os
import sys

_logger = logging.getLogger("pslite_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter(
            "[%(asctime)s %(levelname).1s pslite_tpu_torch] %(message)s"
        )
    )
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


class CheckError(AssertionError):
    """Raised by check() — the CHECK()-failure equivalent."""


def check(cond: bool, msg: str = "") -> None:
    if not cond:
        raise CheckError(msg or "check failed")


def check_eq(a, b, msg: str = "") -> None:
    if a != b:
        raise CheckError(f"check failed: {a!r} != {b!r} {msg}")


def warning(msg: str) -> None:
    _logger.warning(msg)


def fatal_log(msg: str) -> None:
    """Log at error level without raising (for use in except blocks)."""
    _logger.error(msg)


_verbosity_override = 0
_env_level = None  # PS_VERBOSE of the process, read once


def set_verbosity(level: int) -> None:
    """Raise the process-wide verbosity (a Postoffice whose PS_VERBOSE
    arrives through an injected Environment)."""
    global _verbosity_override
    _verbosity_override = max(_verbosity_override, level)


def verbosity() -> int:
    global _env_level
    if _env_level is None:
        try:
            _env_level = int(os.environ.get("PS_VERBOSE", "0"))
        except ValueError:
            _env_level = 0
    return max(_env_level, _verbosity_override)


def vlog(level: int, msg) -> None:
    """Log ``msg`` (a string, or a zero-argument callable formatting it
    only when the level is on) when the verbosity is at least
    ``level``."""
    if verbosity() >= level:
        _logger.info(msg() if callable(msg) else msg)
