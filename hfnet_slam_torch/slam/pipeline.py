"""Synchronous-pipeline lock. The async mapping/loop workers of
hfnet_slam_tpu/slam/pipeline.py are a later slice; until then every stage
runs inline and the map lock is this no-op."""
from __future__ import annotations


class _NullLock:
    """No-op lock: keeps `with self.lock:` and the release/acquire pairs
    around device waits uniform with the async reference."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def acquire(self):
        pass

    def release(self):
        pass


NULL_LOCK = _NullLock()
