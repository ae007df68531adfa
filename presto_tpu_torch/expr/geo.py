"""Geospatial functions on torch.

The JAX package's expr/geo.py: WKT parses once per distinct dictionary
value on the host; per-row geometry work is vector ops on the device —

- geometry → scalar (area, perimeter, bbox, centroid, npoints) are host
  tables over the parsed geometries, gathered by dictionary code;
- point-in-polygon is even-odd ray casting over a padded [G, E] edge
  plane gathered to [rows, E]: compares and a parity sum, holes included
  by the even-odd rule;
- point-to-polygon distance is a min over the point-segment distances of
  the same edge plane.

GEOMETRY values exist only inside one expression tree, as GeomVal: codes
into a parsed table, or point coordinate tensors."""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Geom(NamedTuple):
    kind: str                  # point | linestring | polygon | multipolygon
    polys: tuple               # tuple of polygons; each = tuple of rings;
                               # each ring = tuple of (x, y). point /
                               # linestring: one poly with one "ring"


class GeomVal(NamedTuple):
    """Value of a GEOMETRY-typed expression."""

    kind: str                          # "coded" | "points"
    codes: Optional[torch.Tensor]      # int32 codes into geoms (coded)
    geoms: Optional[tuple]             # tuple[Geom] aligned with codes
    x: Optional[torch.Tensor]          # points kind
    y: Optional[torch.Tensor]


_NUM = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"
_PAIR = re.compile(rf"({_NUM})\s+({_NUM})")


class WktError(ValueError):
    pass


def parse_wkt(s: str) -> Geom:
    """POINT / LINESTRING / POLYGON / MULTIPOLYGON (reference: the ESRI
    WKT importer behind GeoFunctions.ST_GeometryFromText)."""
    s = s.strip()
    m = re.match(r"(?i)^(point|linestring|polygon|multipolygon)\s*(.*)$", s,
                 re.DOTALL)
    if not m:
        raise WktError(f"unsupported WKT: {s[:40]!r}")
    kind = m.group(1).lower()
    body = m.group(2).strip()

    def pairs(text):
        out = tuple((float(a), float(b)) for a, b in _PAIR.findall(text))
        if not out:
            raise WktError(f"no coordinates in WKT: {s[:40]!r}")
        return out

    def rings(text):
        # "( (...), (...) )" → one tuple per parenthesized ring
        return tuple(pairs(r) for r in re.findall(r"\(([^()]*)\)", text))

    if kind == "point":
        return Geom("point", ((pairs(body)[:1],),))
    if kind == "linestring":
        return Geom("linestring", ((pairs(body),),))
    if kind == "polygon":
        rs = rings(body)
        if not rs:
            raise WktError(f"empty polygon: {s[:40]!r}")
        return Geom("polygon", (rs,))
    # multipolygon: split top-level "((...),(...))" groups
    polys = []
    depth = 0
    start = None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 1 and start is None:
                start = i
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 1 and start is not None:
                polys.append(rings(body[start:i + 1]))
                start = None
    if not polys:
        raise WktError(f"empty multipolygon: {s[:40]!r}")
    return Geom("multipolygon", tuple(polys))


# -- host-side per-geometry metrics (LUT sources) ---------------------------


def _ring_area2(ring) -> float:
    """Twice the signed shoelace area."""
    a = 0.0
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        a += x1 * y2 - x2 * y1
    return a


def geom_area(g: Geom) -> float:
    if g.kind in ("point", "linestring"):
        return 0.0
    total = 0.0
    for rings in g.polys:
        ext = abs(_ring_area2(rings[0])) / 2.0
        holes = sum(abs(_ring_area2(r)) / 2.0 for r in rings[1:])
        total += ext - holes
    return total


def _chain_length(pts, closed: bool) -> float:
    n = len(pts)
    if n < 2:
        return 0.0
    total = 0.0
    last = n if closed else n - 1
    for i in range(last):
        x1, y1 = pts[i]
        x2, y2 = pts[(i + 1) % n]
        total += math.hypot(x2 - x1, y2 - y1)
    return total


def geom_perimeter(g: Geom) -> float:
    if g.kind in ("point", "linestring"):
        return 0.0
    return sum(_chain_length(r, True) for rings in g.polys for r in rings)


def geom_length(g: Geom) -> float:
    if g.kind == "linestring":
        return _chain_length(g.polys[0][0], False)
    return 0.0


def geom_npoints(g: Geom) -> int:
    return sum(len(r) for rings in g.polys for r in rings)


def geom_bbox(g: Geom):
    xs = [p[0] for rings in g.polys for r in rings for p in r]
    ys = [p[1] for rings in g.polys for r in rings for p in r]
    return min(xs), min(ys), max(xs), max(ys)


def geom_centroid(g: Geom):
    if g.kind in ("point", "linestring"):
        pts = g.polys[0][0]
        return (sum(p[0] for p in pts) / len(pts),
                sum(p[1] for p in pts) / len(pts))
    # area-weighted centroid; holes subtract (signed shoelace terms)
    sx = sy = sa = 0.0
    for rings in g.polys:
        for ri, ring in enumerate(rings):
            a2 = _ring_area2(ring)
            sign = 1.0 if ri == 0 else -1.0
            w = sign * abs(a2)
            cx = cy = 0.0
            n = len(ring)
            if abs(a2) < 1e-30:
                continue
            for i in range(n):
                x1, y1 = ring[i]
                x2, y2 = ring[(i + 1) % n]
                cross = x1 * y2 - x2 * y1
                cx += (x1 + x2) * cross
                cy += (y1 + y2) * cross
            # cross terms carry the ring's own sign; normalize to |area|
            cx = cx / (3.0 * a2) * abs(a2)
            cy = cy / (3.0 * a2) * abs(a2)
            sx += sign * cx
            sy += sign * cy
            sa += w
    if sa == 0.0:
        return geom_bbox(g)[:2]
    return sx / sa, sy / sa


def is_point(g: Geom) -> bool:
    return g.kind == "point"


def is_area(g: Geom) -> bool:
    """Only polygons enclose area — ray-casting parity is meaningless
    for points/linestrings."""
    return g.kind in ("polygon", "multipolygon")


def point_xy(g: Geom):
    p = g.polys[0][0][0]
    return p[0], p[1]


# -- padded edge planes (device containment / distance) ---------------------


def edge_planes(geoms: tuple):
    """[G, E] edge endpoint planes over every ring of every geometry
    (even-odd ray casting is hole-correct over the concatenated rings).
    Padding edges are NaN — every comparison against them is False."""
    all_edges = []
    for g in geoms:
        edges = []
        closed = g.kind in ("polygon", "multipolygon")
        for rings in g.polys:
            for ring in rings:
                n = len(ring)
                if n < 2:
                    continue
                # open chains (linestrings) have n-1 edges — no phantom
                # closing segment
                for i in range(n if closed else n - 1):
                    x1, y1 = ring[i]
                    x2, y2 = ring[(i + 1) % n]
                    edges.append((x1, y1, x2, y2))
        all_edges.append(edges)
    emax = max((len(e) for e in all_edges), default=1) or 1
    G = len(geoms)
    planes = np.full((4, G, emax), np.nan)
    for gi, edges in enumerate(all_edges):
        for ei, (x1, y1, x2, y2) in enumerate(edges):
            planes[0, gi, ei] = x1
            planes[1, gi, ei] = y1
            planes[2, gi, ei] = x2
            planes[3, gi, ei] = y2
    return planes


def _edges(planes: np.ndarray, codes: torch.Tensor):
    """Each row's geometry's edges: four [rows, E] tensors."""
    p = torch.as_tensor(planes, device=codes.device)
    c = torch.clamp(codes.to(torch.int64), 0, p.shape[1] - 1)
    return tuple(p[i][c] for i in range(4))


def point_in_coded(planes, codes, px, py):
    """Even-odd ray casting: [rows] bool. planes [4, G, E]; codes [rows];
    px/py [rows] float (a horizontal ray to +inf; NaN pad edges never
    cross)."""
    ex1, ey1, ex2, ey2 = _edges(planes, codes)
    pyc, pxc = py[:, None], px[:, None]
    straddle = (ey1 > pyc) != (ey2 > pyc)
    # x where the edge crosses the ray's y
    t = (pyc - ey1) / (ey2 - ey1)
    xcross = ex1 + t * (ex2 - ex1)
    crossing = straddle & (pxc < xcross)
    return (torch.sum(crossing, dim=1) % 2).to(torch.bool)


def point_seg_distance(planes, codes, px, py):
    """Least distance from each point to its geometry's edges: [rows]
    float64 (inf where the geometry has no edge)."""
    ex1, ey1, ex2, ey2 = _edges(planes, codes)
    pxc, pyc = px[:, None], py[:, None]
    dx, dy = ex2 - ex1, ey2 - ey1
    ll = dx * dx + dy * dy
    pos = ll > 0
    t = torch.where(pos, ((pxc - ex1) * dx + (pyc - ey1) * dy)
                    / torch.where(pos, ll, torch.ones_like(ll)),
                    torch.zeros_like(ll))
    t = torch.clamp(t, 0.0, 1.0)
    cx, cy = ex1 + t * dx, ey1 + t * dy
    d = torch.hypot(pxc - cx, pyc - cy)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return torch.amin(d, dim=1)


def great_circle_distance(lat1, lon1, lat2, lon2):
    """Haversine in kilometres (earth radius 6371.01 km, as the JAX
    package and Presto's GeoFunctions.greatCircleDistance)."""
    r = 6371.01
    p1, p2 = torch.deg2rad(lat1), torch.deg2rad(lat2)
    dphi = p2 - p1
    dlam = torch.deg2rad(lon2) - torch.deg2rad(lon1)
    a = (torch.sin(dphi / 2.0) ** 2
         + torch.cos(p1) * torch.cos(p2) * torch.sin(dlam / 2.0) ** 2)
    return 2.0 * r * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
