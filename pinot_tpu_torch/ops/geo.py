"""Geospatial scalar functions (host-side).

Equivalent of the reference's geospatial package
(pinot-core/.../geospatial/transform/function/: StPointFunction,
StDistanceFunction, StContainsFunction, StAsTextFunction,
StGeogFromTextFunction...). The reference delegates geometry to JTS and
H3 (JNI); here geography stays WKT-string-encoded (POINT/POLYGON) with
numpy haversine math — SURVEY §7 keeps geo host-side permanently.

Coordinates are (longitude, latitude) in degrees, like the reference's
geography type; distances are meters on the WGS84 mean sphere.
"""

from __future__ import annotations

import re

import numpy as np

EARTH_RADIUS_M = 6_371_008.8

_POINT_RE = re.compile(
    r"\s*POINT\s*\(\s*(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s+"
    r"(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*\)\s*", re.IGNORECASE)
_POLY_RE = re.compile(r"\s*POLYGON\s*\(\((.*?)\)\)\s*", re.IGNORECASE | re.DOTALL)


def _as_str_array(a) -> np.ndarray:
    return np.atleast_1d(np.asarray(a)).astype(str)


def parse_points(arr) -> tuple:
    """(lon, lat) float64 arrays from WKT POINT strings; malformed -> NaN."""
    s = _as_str_array(arr)
    lon = np.full(len(s), np.nan)
    lat = np.full(len(s), np.nan)
    for i, w in enumerate(s):
        m = _POINT_RE.fullmatch(w)
        if m:
            lon[i] = float(m.group(1))
            lat[i] = float(m.group(2))
    return lon, lat


def parse_polygon(wkt: str) -> np.ndarray:
    """(n, 2) lon/lat ring from a WKT POLYGON's outer ring."""
    m = _POLY_RE.fullmatch(str(wkt))
    if not m:
        raise ValueError(f"not a WKT POLYGON: {wkt!r}")
    pts = []
    for pair in m.group(1).split(","):
        x, y = pair.split()
        pts.append((float(x), float(y)))
    return np.asarray(pts, dtype=np.float64)


def st_point(lon, lat) -> np.ndarray:
    lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    lon, lat = np.broadcast_arrays(lon, lat)
    return np.asarray([f"POINT ({x:.10g} {y:.10g})" for x, y in zip(lon, lat)])


def st_geog_from_text(wkt) -> np.ndarray:
    return _as_str_array(wkt)


def st_as_text(geo) -> np.ndarray:
    return _as_str_array(geo)


def haversine_m(lon1, lat1, lon2, lat2) -> np.ndarray:
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def st_distance(a, b) -> np.ndarray:
    """Sphere distance in meters between two POINT columns/literals
    (StDistanceFunction geography semantics)."""
    lon1, lat1 = parse_points(a)
    lon2, lat2 = parse_points(b)
    lon1, lon2 = np.broadcast_arrays(lon1, lon2)
    lat1, lat2 = np.broadcast_arrays(lat1, lat2)
    return haversine_m(lon1, lat1, lon2, lat2)


def st_polygon(wkt) -> np.ndarray:
    """ST_Polygon: validate + normalize a WKT POLYGON (reference
    StPolygonFunction constructs the geometry; here geometries stay WKT)."""
    s = _as_str_array(wkt)
    for w in s:
        parse_polygon(w)  # raises on malformed input
    return s


def st_area(poly_wkt) -> np.ndarray:
    """Spherical polygon area in m² (StAreaFunction geography semantics):
    the spherical excess via L'Huilier-free line-integral form."""
    s = _as_str_array(poly_wkt)
    out = np.zeros(len(s), dtype=np.float64)
    for i, w in enumerate(s):
        ring = parse_polygon(w)
        lon = np.radians(ring[:, 0])
        lat = np.radians(ring[:, 1])
        if lon[0] != lon[-1] or lat[0] != lat[-1]:
            lon = np.append(lon, lon[0])
            lat = np.append(lat, lat[0])
        # spherical excess line integral: sum (λ2-λ1)·(2+sinφ1+sinφ2)/2
        area = np.sum(
            (lon[1:] - lon[:-1])
            * (2 + np.sin(lat[:-1]) + np.sin(lat[1:]))) / 2.0
        out[i] = abs(area) * EARTH_RADIUS_M * EARTH_RADIUS_M
    return out


# ---- WKB (well-known binary) points ---------------------------------------
# Reference: ST_GeomFromWKB / ST_AsBinary over JTS; here little-endian WKB
# point encoding per the OGC spec (byte order 1, type 1, two f64s).

import struct as _struct


def st_as_binary(points) -> np.ndarray:
    lon, lat = parse_points(points)
    out = np.empty(len(lon), dtype=object)
    for i in range(len(lon)):
        out[i] = _struct.pack("<BIdd", 1, 1, lon[i], lat[i])
    return out


def st_geom_from_wkb(blobs) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(blobs, dtype=object))
    lon = np.full(len(arr), np.nan)
    lat = np.full(len(arr), np.nan)
    for i, b in enumerate(arr):
        if isinstance(b, (bytes, bytearray)) and len(b) >= 21:
            (order,) = _struct.unpack_from("<B", b, 0)
            fmt = "<" if order == 1 else ">"
            (gtype,) = _struct.unpack_from(fmt + "I", b, 1)
            if gtype == 1:
                lon[i], lat[i] = _struct.unpack_from(fmt + "dd", b, 5)
    return st_point(lon, lat)


def _points_in_ring(ring: np.ndarray, lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """Vectorized even-odd ray cast (planar lon/lat, like JTS contains on
    geometries): True where (lon, lat) falls inside the ring."""
    inside = np.zeros(len(lon), dtype=bool)
    x0, y0 = ring[-1]
    for x1, y1 in ring:
        crosses = ((y1 > lat) != (y0 > lat))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (x0 - x1) * (lat - y1) / (y0 - y1) + x1
        inside ^= crosses & (lon < xint)
        x0, y0 = x1, y1
    return inside


def st_contains(poly_wkt, points) -> np.ndarray:
    """Polygon contains point — polygon is a (usually literal) WKT POLYGON,
    points a POINT column (StContainsFunction arg order). Either side may
    be scalar; both broadcast like any binary transform."""
    polys = _as_str_array(poly_wkt)
    lon, lat = parse_points(points)
    if len(polys) == 1:
        ring = parse_polygon(polys[0])
        out = _points_in_ring(ring, lon, lat)
        return out & ~np.isnan(lon)
    polys, lon, lat = np.broadcast_arrays(polys, lon, lat)
    out = np.zeros(len(lon), dtype=bool)
    for i, p in enumerate(polys):
        out[i] = bool(_points_in_ring(parse_polygon(p),
                                      lon[i: i + 1], lat[i: i + 1])[0])
    return out & ~np.isnan(lon)


def st_within(points, poly_wkt) -> np.ndarray:
    """Point within polygon — flipped argument order (StWithinFunction)."""
    return st_contains(poly_wkt, points)


_WKT_TYPES = {
    "POINT": "Point", "LINESTRING": "LineString", "POLYGON": "Polygon",
    "MULTIPOINT": "MultiPoint", "MULTILINESTRING": "MultiLineString",
    "MULTIPOLYGON": "MultiPolygon",
    "GEOMETRYCOLLECTION": "GeometryCollection",
}


def st_geometry_type(geo) -> np.ndarray:
    """JTS Geometry.getGeometryType() analog: the WKT type token in JTS
    capitalization (StGeometryTypeFunction.java:74)."""
    s = _as_str_array(geo)
    out = np.empty(len(s), dtype=object)
    for i, w in enumerate(s):
        tok = str(w).strip().split("(")[0].strip().split()[0].upper() \
            if str(w).strip() else ""
        out[i] = _WKT_TYPES.get(tok, tok.title() if tok else "")
    return out


def _normalize_wkt(w: str) -> str:
    return " ".join(str(w).upper().replace("(", " ( ").replace(")", " ) ")
                    .replace(",", " , ").split())


def st_equals(a, b) -> np.ndarray:
    """Geometry equality (StEqualsFunction role): POINT pairs compare by
    coordinates; other WKT pairs by normalized text — sufficient for the
    point/polygon geometry model this build carries (ops/geo.py)."""
    aa, bb = _as_str_array(a), _as_str_array(b)
    aa, bb = np.broadcast_arrays(aa, bb)
    lon_a, lat_a = parse_points(aa)
    lon_b, lat_b = parse_points(bb)
    out = np.zeros(len(aa), dtype=bool)
    for i in range(len(aa)):
        if not np.isnan(lon_a[i]) and not np.isnan(lon_b[i]):
            out[i] = lon_a[i] == lon_b[i] and lat_a[i] == lat_b[i]
        else:
            out[i] = _normalize_wkt(aa[i]) == _normalize_wkt(bb[i])
    return out


def grid_cell(lon, lat, resolution) -> np.ndarray:
    """geoToH3's role on this build's grid scheme (storage/geoindex.py):
    pack (floor(lat/res_deg), floor(lon/res_deg)) into an int64 cell id
    with the resolution in the top byte, so ids from different resolutions
    never collide (like H3's resolution-tagged indexes). res_deg halves
    per resolution step: res 0 = 360 deg, res r = 360/2^r deg.
    NaN coordinates yield -1 (no cell)."""
    lon = np.atleast_1d(np.asarray(lon, dtype=np.float64))
    lat = np.atleast_1d(np.asarray(lat, dtype=np.float64))
    res = np.atleast_1d(np.asarray(resolution, dtype=np.int64))
    lon, lat, res = np.broadcast_arrays(lon, lat, res)
    # at res r, cj spans 2^r values and ci 2^(r-1): both must fit their
    # packed fields (27 / 26 bits), so 27 is the finest resolution
    # (~0.3m cells) before indices would alias across the planet
    res = np.clip(res, 0, 27)
    res_deg = 360.0 / (np.int64(1) << res)
    ci = np.floor(lat / res_deg).astype(np.int64)
    cj = np.floor(lon / res_deg).astype(np.int64)
    cell = (res.astype(np.int64) << 54) | ((ci & 0x3FFFFFF) << 27) \
        | (cj & 0x7FFFFFF)
    return np.where(np.isnan(lon) | np.isnan(lat), np.int64(-1), cell)
