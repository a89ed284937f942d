"""Atlas: the multi-map container, the lost-recovery policy and whole-session
persistence.

Counterpart of hfnet_slam_tpu/slam/atlas.py: map creation on tracking loss,
discard of immature maps, and SaveAtlas/LoadAtlas as a directory of one .npz
per map (MapStore.save, the reference's format) plus `atlas.json`, a manifest
with the capacities, the active map and each file's md5. The format is the
reference's in both directions: either package loads what the other writes.
"""
from __future__ import annotations

import hashlib
import json
import os

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

    def index_of(self, store: MapStore) -> int:
        """Position of `store` in maps, by identity: MapStore's dataclass
        equality compares only the capacities, so list.index would return
        the first map of the same size."""
        return next(i for i, m in enumerate(self.maps) if m is store)

    def create_new_map(self) -> MapStore:
        """Store the current map and start a fresh one (CreateMapInAtlas)."""
        self.maps.append(MapStore(*self._caps))
        self.active_idx = len(self.maps) - 1
        return self.active

    def reset_active_map(self) -> MapStore:
        """Discard the active map in place (ResetActiveMap)."""
        self.maps[self.active_idx] = MapStore(*self._caps)
        return self.active

    def remove_bad_maps(self, min_kfs: int = 3):
        """Drop stored maps too small to ever merge (Atlas::RemoveBadMaps);
        the active map stays whatever its size."""
        active = self.active
        self.maps = [m for m in self.maps if m is active or m.kf_valid.sum() >= min_kfs]
        self.active_idx = self.index_of(active)

    # ------------------------------------------------------------------
    # persistence (SaveAtlas / LoadAtlas)
    # ------------------------------------------------------------------
    def save(self, path):
        os.makedirs(path, exist_ok=True)
        names = [f"map_{i}.npz" for i in range(len(self.maps))]
        for m, name in zip(self.maps, names):
            m.save(os.path.join(path, name))
        # an md5 per map file (System::CalculateCheckSum)
        manifest = {"n_maps": len(self.maps), "active": self.active_idx,
                    "caps": list(self._caps), "version": 1,
                    "md5": {name: _md5(os.path.join(path, name)) for name in names}}
        with open(os.path.join(path, "atlas.json"), "w") as f:
            json.dump(manifest, f)

    @staticmethod
    def load(path) -> "Atlas":
        """Raises IOError when a map file's md5 differs from the manifest's."""
        with open(os.path.join(path, "atlas.json")) as f:
            manifest = json.load(f)
        for name, want in manifest["md5"].items():
            got = _md5(os.path.join(path, name))
            if got != want:
                raise IOError(f"atlas snapshot corrupted: {name} md5 {got} != {want}")
        atlas = Atlas(*manifest["caps"])
        atlas.maps = [MapStore.load(os.path.join(path, f"map_{i}.npz"))
                      for i in range(manifest["n_maps"])]
        atlas.active_idx = manifest["active"]
        return atlas


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
