"""Atlas: the multi-map container and lost-recovery policy.

Counterpart of hfnet_slam_tpu/slam/atlas.py: map creation on tracking loss
and discard of immature maps. Whole-session persistence (save_atlas /
load_atlas) is still to port; single maps persist through MapStore.save.
"""
from __future__ import annotations

from .map import MapStore


class Atlas:
    def __init__(self, k_max, m_max, n_slots, desc_dim, gdesc_dim):
        self._caps = (k_max, m_max, n_slots, desc_dim, gdesc_dim)
        self.maps: list[MapStore] = [MapStore(*self._caps)]
        self.active_idx = 0

    @property
    def active(self) -> MapStore:
        return self.maps[self.active_idx]

    def n_maps(self) -> int:
        return len(self.maps)

    def create_new_map(self) -> MapStore:
        """Store the current map and start a fresh one (CreateMapInAtlas)."""
        self.maps.append(MapStore(*self._caps))
        self.active_idx = len(self.maps) - 1
        return self.active

    def reset_active_map(self) -> MapStore:
        """Discard the active map in place (ResetActiveMap)."""
        self.maps[self.active_idx] = MapStore(*self._caps)
        return self.active
