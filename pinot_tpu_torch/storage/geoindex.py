"""Geospatial filter index: the reference H3 index's role, grid-cell form.

Reference (pinot-segment-local/.../readers/geospatial/
ImmutableH3IndexReader.java + H3IndexFilterOperator): POINT columns get a
cell → doc-bitmap index so ``ST_Distance(col, point) < r`` prunes to the
cells covering the query circle instead of scanning every doc. H3 is a
JNI-backed hexagonal library; the equivalent capability here is a fixed
lat/lon **grid** index — cells are ``(floor(lat/res), floor(lon/res))``
at 0.5°, candidate cells are the bounding box of the query circle
(superset, so the exact haversine verify on candidates preserves
correctness), and postings are doc ids.
"""

from __future__ import annotations

import os

import numpy as np

RES_DEG = 0.5
_M_PER_DEG_LAT = 111_320.0

CELLS_FILE = "{col}.geo.cells.npy"
DOCS_FILE = "{col}.geo.docs.npy"
OFFS_FILE = "{col}.geo.off.npy"


def _cell_ids(lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """int64 cell key; NaN coordinates land in a sentinel cell that no
    query bbox covers."""
    ok = np.isfinite(lon) & np.isfinite(lat)
    ci = np.floor(np.where(ok, lat, 1000.0) / RES_DEG).astype(np.int64)
    cj = np.floor(np.where(ok, lon, 1000.0) / RES_DEG).astype(np.int64)
    return ci * 100_000 + cj


class GeoGridIndex:
    def __init__(self, cells: np.ndarray, docs: np.ndarray, offs: np.ndarray):
        self.cells = cells  # sorted unique int64 cell keys
        self.docs = docs    # concatenated int32 doc postings
        self.offs = offs    # (n_cells+1,) int64

    @classmethod
    def build(cls, point_wkts) -> "GeoGridIndex":
        from pinot_tpu_torch.ops.geo import parse_points

        lon, lat = parse_points(point_wkts)
        keys = _cell_ids(lon, lat)
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        cells, starts = np.unique(sk, return_index=True)
        offs = np.append(starts, len(sk)).astype(np.int64)
        return cls(cells, order.astype(np.int32), offs)

    def save(self, dir_path: str, col: str) -> None:
        np.save(os.path.join(dir_path, CELLS_FILE.format(col=col)),
                self.cells, allow_pickle=False)
        np.save(os.path.join(dir_path, DOCS_FILE.format(col=col)),
                self.docs, allow_pickle=False)
        np.save(os.path.join(dir_path, OFFS_FILE.format(col=col)),
                self.offs, allow_pickle=False)

    @classmethod
    def load(cls, dir_path: str, col: str):
        cp = os.path.join(dir_path, CELLS_FILE.format(col=col))
        if not os.path.exists(cp):
            return None
        return cls(
            np.load(cp, allow_pickle=False),
            np.load(os.path.join(dir_path, DOCS_FILE.format(col=col)),
                    allow_pickle=False, mmap_mode="r"),
            np.load(os.path.join(dir_path, OFFS_FILE.format(col=col)),
                    allow_pickle=False),
        )

    def candidate_docs(self, lon: float, lat: float, radius_m: float):
        """Doc ids in every cell intersecting the circle's bounding box
        (superset of true matches; caller verifies with exact haversine).
        Returns None — "no narrowing, scan" — when the bbox crosses the
        antimeridian or approaches a pole, where a raw-longitude box is
        NOT a superset of the circle."""
        dlat = radius_m / _M_PER_DEG_LAT
        if abs(lat) + dlat > 85.0:
            return None  # near-pole: lon spans wrap unpredictably
        max_abs_lat = abs(lat) + dlat
        dlon = radius_m / (_M_PER_DEG_LAT *
                           max(np.cos(np.radians(max_abs_lat)), 1e-6))
        if lon - dlon < -180.0 or lon + dlon > 180.0:
            return None  # antimeridian wrap: cells split across the seam
        lat_lo = int(np.floor((lat - dlat) / RES_DEG))
        lat_hi = int(np.floor((lat + dlat) / RES_DEG))
        lon_lo = int(np.floor((lon - dlon) / RES_DEG))
        lon_hi = int(np.floor((lon + dlon) / RES_DEG))
        chunks = []
        for ci in range(lat_lo, lat_hi + 1):
            # cells are sorted by (ci, cj): one contiguous band per ci
            lo = np.searchsorted(self.cells, ci * 100_000 + lon_lo)
            hi = np.searchsorted(self.cells, ci * 100_000 + lon_hi,
                                 side="right")
            for j in range(lo, hi):
                chunks.append(np.asarray(
                    self.docs[self.offs[j]: self.offs[j + 1]]))
        if not chunks:
            return np.empty(0, dtype=np.int32)
        return np.sort(np.concatenate(chunks))
