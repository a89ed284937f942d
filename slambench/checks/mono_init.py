"""Check kind `mono_init`: the monocular initialization of each window
episode, a fact of the whole run. uninit_episodes: the episodes started in
the window that had no map (no keyframe) after the traffic's `init_frames`
frames (the feed's `init_log`). Every episode of the cell starts from an
empty map on frames that initialize, so a sound run reads 0: the number is
exact. None (a failed check) where no episode started or the feed keeps no
log.
"""
from __future__ import annotations


def hook(cap, run, feed):
    return []


def numbers(samples, run, feed, device, control):
    log = getattr(feed, "init_log", None)
    if control or not log:
        return {}
    return {"uninit_episodes": float(sum(not e["has_map"] for e in log))}
