"""Package logger. warn() is unconditional: it reports conditions that
silently degrade results (capacity growth, dropped edges)."""
from __future__ import annotations

import logging

logger = logging.getLogger("hfnet_slam_torch")


def warn(msg: str) -> None:
    logger.warning(msg)
