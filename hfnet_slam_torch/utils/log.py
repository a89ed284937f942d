"""Leveled logging (Verbose::PrintMess): QUIET / NORMAL / VERBOSE /
VERY_VERBOSE / DEBUG with one process-wide threshold, QUIET by default.

One stdlib logger for the package, with the five levels mapped onto
logging's scale, so handlers and formatting come from the standard library
while call sites keep the reference's vocabulary:

    from hfnet_slam_torch.utils import log
    log.set_level("normal")
    log.print_mess("loop closed", log.VERBOSE)   # suppressed

warn() is unconditional: it reports conditions that silently degrade
results (capacity growth, dropped edges), whatever the threshold.
"""
from __future__ import annotations

import logging

QUIET = 0
NORMAL = 1
VERBOSE = 2
VERY_VERBOSE = 3
DEBUG = 4

_NAMES = {"quiet": QUIET, "normal": NORMAL, "verbose": VERBOSE,
          "very_verbose": VERY_VERBOSE, "debug": DEBUG}

# level -> stdlib severity of messages at that level
_PY_LEVEL = {NORMAL: logging.INFO, VERBOSE: logging.DEBUG,
             VERY_VERBOSE: logging.DEBUG - 1, DEBUG: logging.DEBUG - 2}

logger = logging.getLogger("hfnet_slam_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.propagate = False

_threshold = QUIET


def set_level(level) -> None:
    """Accepts a name ('normal'), a constant (log.VERBOSE) or any other
    number, a stdlib level included, which becomes the threshold as it is
    (as in the JAX package)."""
    global _threshold
    if isinstance(level, str):
        level = _NAMES[level.lower()]
    _threshold = int(level)
    # warn() always passes, whatever the threshold
    logger.setLevel(min(logging.WARNING,
                        _PY_LEVEL.get(_threshold, logging.CRITICAL + 1)
                        if _threshold > QUIET else logging.CRITICAL + 1))


def get_level() -> int:
    return _threshold


def print_mess(msg: str, level: int = NORMAL) -> None:
    """Emit msg when the threshold is at least its level."""
    if QUIET < level <= _threshold:
        logger.log(_PY_LEVEL.get(level, logging.INFO), msg)


def warn(msg: str) -> None:
    logger.log(logging.WARNING, msg)


set_level(QUIET)
