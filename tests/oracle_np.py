"""Float64 numpy/scipy oracle: a direct transliteration of the reference
algorithm for differential testing.

No Fortran compiler exists in this environment, so the test oracle is an
independent scalar-path reimplementation of ``GCLIB_GJKEPA`` semantics
(``/root/reference/src/GCLIB_GJKEPA.f90``), written against the source as
specification.  It follows the reference's *exact* control flow — including
the always-tetra GJK update, the stagnation-based miss verdicts, and the
rebuild-the-hull-each-iteration EPA — with ``scipy.spatial.ConvexHull``
(qhull) standing in for the repo-external ``GCLIB_QuickHull`` /
``GCLIB_DeHull`` modules the reference imports but does not ship
(SURVEY.md §2.3).

This module is TEST INFRASTRUCTURE ONLY: the production engine in
``gjkepa/`` shares no code with it and uses different mechanisms
(masked array programs, incremental EPA).

Where the reference halts interactively (WRITE + PAUSE/STOP on impossible
states) this oracle raises :class:`OracleHalt`; differential tests skip
those configurations.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gjkepa.ops.directions import DIRECTION_TABLE

try:
    from scipy.spatial import ConvexHull
    from scipy.spatial import QhullError
except ImportError:  # pragma: no cover
    ConvexHull = None
    QhullError = Exception

O = np.zeros(3)


class OracleHalt(Exception):
    """The reference would PAUSE/STOP (or hit undefined behavior) here."""


@dataclasses.dataclass
class OracleResult:
    hit: bool
    colli_type: int = 0
    nearest_points: np.ndarray = None
    normal: np.ndarray = None
    contact_point: np.ndarray = None
    depth: float = 0.0
    epa_capped: bool = False

    def __post_init__(self):
        if self.nearest_points is None:
            self.nearest_points = np.zeros((2, 3))
        if self.normal is None:
            self.normal = np.zeros(3)
        if self.contact_point is None:
            self.contact_point = np.zeros(3)


# ---------------------------------------------------------------------------
# math tools (ref :1193-1689)
# ---------------------------------------------------------------------------

def utzvec(v):
    n = np.linalg.norm(v)
    return np.zeros_like(v) if n < 1e-12 else v / n


def uninml(tri):
    c = np.cross(tri[1] - tri[0], tri[2] - tri[1])
    if np.any(np.abs(c) > 1e-12):
        return c / np.linalg.norm(c)
    return np.zeros(3)


def dist_pf_sign(p, tri):
    n = uninml(tri)
    if np.all(np.abs(n) < 1e-12):
        raise OracleHalt("DIST_PF_SIGN degenerate plane (ref :1369-1373)")
    return float(np.dot(p - tri[0], n))


def vec_pl(p, line):
    a, b = line
    ab = b - a
    d = a + np.dot(p - a, ab) / np.linalg.norm(ab) * utzvec(ab)
    return utzvec(d - p)


def foot_pl(p, line):
    u = utzvec(line[1] - line[0])
    return line[0] + np.dot(p - line[0], u) * u


def foot_ll(l1, l2):
    p1, q1 = l1
    p2, q2 = l2
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, b, c = np.dot(d1, d1), np.dot(d1, d2), np.dot(d1, r)
    e, f = np.dot(d2, d2), np.dot(d2, r)
    d = a * e - b * b
    if abs(d) < 1e-12:
        m = (p1 + q1) / 2.0
        return np.stack([m, foot_pl(m, l2)])
    s = (b * f - c * e) / d
    t = (a * f - b * c) / d
    return np.stack([p1 + s * d1, p2 + t * d2])


def is_inside_pf(V, p):
    n = len(V)
    c = np.empty(n)
    for i in range(n):
        j = (i + 1) % n
        c[i] = (V[j, 0] - V[i, 0]) * (p[1] - V[i, 1]) - (V[j, 1] - V[i, 1]) * (p[0] - V[i, 0])
    c[np.abs(c) < 1e-12] = 0.0
    if not np.any(c > 1e-15):  # all-nonpositive quirk -> XOZ projection
        for i in range(n):
            j = (i + 1) % n
            c[i] = (V[j, 0] - V[i, 0]) * (p[2] - V[i, 2]) - (V[j, 2] - V[i, 2]) * (p[0] - V[i, 0])
    return not np.any(c[0] * c < 0.0)


_ID_FC = [[0, 2, 3], [0, 1, 3], [0, 1, 2], [1, 2, 3]]


def point_in_simplex(p, s):
    m = s.mean(axis=0)
    dist = np.empty(4)
    nml = np.empty((4, 3))
    for i, f in enumerate(_ID_FC):
        ab = s[f[0]] - s[f[1]]
        bc = s[f[1]] - s[f[2]]
        n = utzvec(np.cross(ab, bc))
        if np.dot(n, s[i] - m) < 0.0:
            n = -n
        nml[i] = n
        dist[i] = np.dot(s[i] - p, n)
    for i, f in enumerate(_ID_FC):
        if abs(dist[i]) < 1e-8 and is_inside_pf(s[f], p):
            return True
    return bool(np.all(dist > 0.0))


def overlap(pts):
    return all(np.all(np.abs(pts[i] - pts[j]) <= 1e-12)
               for i in range(len(pts)) for j in range(i + 1, len(pts)))


def sort_clock(pts):
    """Greedy CCW chain around the centroid (ref :1513-1575)."""
    if overlap(pts):
        return pts.copy()  # ref returns unset output; input order by convention
    n = len(pts)
    centroid = pts.mean(axis=0)
    normal = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    ordered = [pts[0]]
    for _ in range(1, n):
        best, best_ang = -1, np.inf
        for j in range(n):
            if any(np.array_equal(pts[j], o) for o in ordered):
                continue
            v1 = pts[j] - centroid
            v2 = ordered[-1] - centroid
            ang = np.arctan2(np.dot(normal, np.cross(v2, v1)), np.dot(v1, v2))
            ang = np.mod(ang + 2 * np.pi, 2 * np.pi)
            if ang < best_ang:
                best_ang, best = ang, j
        if best < 0:
            raise OracleHalt("SORT_CLOCK exact-duplicate points (UB in ref)")
        ordered.append(pts[best])
    return np.stack(ordered)


# ---------------------------------------------------------------------------
# support / broadphase (ref :1030-1062, :1165-1188)
# ---------------------------------------------------------------------------

def support_mapping(p1, p2, d):
    return p1[np.argmax(p1 @ d)] - p2[np.argmax(p2 @ -d)]


def rough_collision(p1, p2):
    c1, c2 = p1.mean(axis=0), p2.mean(axis=0)
    r1 = np.max(np.linalg.norm(p1 - c1, axis=1))
    r2 = np.max(np.linalg.norm(p2 - c2, axis=1))
    return np.linalg.norm(c1 - c2) <= r1 + r2 + 1.0


# ---------------------------------------------------------------------------
# GJK (ref :39-239, :1070-1157)
# ---------------------------------------------------------------------------

def update_simplex_gjk(p1, p2, s):
    m = s.mean(axis=0)
    edges = [(0, 2, 2, 3), (0, 1, 1, 3), (0, 1, 1, 2), (1, 2, 2, 3)]
    ref_v = [0, 0, 0, 1]
    keep = [[0, 2, 3], [0, 1, 3], [0, 1, 2], [1, 2, 3]]
    nml = np.empty((4, 3))
    dist = np.empty(4)
    for i, (a1, a2, b1, b2) in enumerate(edges):
        n = utzvec(np.cross(s[a1] - s[a2], s[b1] - s[b2]))
        if np.dot(n, s[ref_v[i]] - m) < 0.0:
            n = -n
        nml[i] = n
        dist[i] = np.dot(-n, s[ref_v[i]] - O)
    k = int(np.argmax(dist))
    sm = support_mapping(p1, p2, nml[k])
    return np.stack([s[keep[k][0]], s[keep[k][1]], s[keep[k][2]], sm])


def gjkepa_oracle(p1, p2, version=2, tol_ff=1.0):
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    if not rough_collision(p1, p2):
        return OracleResult(hit=False)

    # init v1/v2 with retry (ref :82-112)
    it = 0
    while True:
        it += 1
        if it > 99:
            return OracleResult(hit=False)
        d = DIRECTION_TABLE[it - 1]
        s1 = support_mapping(p1, p2, d)
        s2 = support_mapping(p1, p2, -d)
        if not np.all(np.abs(s1 - s2) < 1e-8):
            break

    # v3 (ref :115-127)
    d = vec_pl(O, np.stack([s1, s2]))
    s3 = support_mapping(p1, p2, d)
    if np.all(np.abs(s3 - s1) < 1e-8) or np.all(np.abs(s3 - s2) < 1e-8):
        return OracleResult(hit=False)

    # v4 (ref :130-170)
    d = utzvec(np.cross(s2 - s1, s3 - s2))
    vo = O - s3
    if abs(np.dot(vo, d)) < 1e-8 and is_inside_pf(np.stack([s1, s2, s3]), O):
        # Reference UB: stale 4th vertex (:143-145).  Convention shared with
        # the engine: fresh support along the (unflipped) tri normal,
        # opposite side if coplanar.
        s4e = support_mapping(p1, p2, d)
        tri = np.stack([s1, s2, s3])
        try:
            cop = abs(dist_pf_sign(s4e, tri)) < 1e-8
        except OracleHalt:
            cop = True
        if cop:
            s4e = support_mapping(p1, p2, -d)
        return _epa(p1, p2, np.stack([s1, s2, s3, s4e]), version, tol_ff)

    if np.dot(vo, d) < 0.0:
        d = -d
    s4 = support_mapping(p1, p2, d)
    if abs(dist_pf_sign(s4, np.stack([s1, s2, s3]))) < 1e-8:
        return OracleResult(hit=False)
    simplex = np.stack([s1, s2, s3, s4])
    if point_in_simplex(O, simplex):
        return _epa(p1, p2, simplex, version, tol_ff)

    # iterate loop (ref :178-236)
    last1 = np.zeros((4, 3))
    last2 = np.zeros((4, 3))
    it = 0
    while True:
        it += 1
        if it > 50:
            return OracleResult(hit=False)
        last2, last1 = last1, simplex
        simplex = update_simplex_gjk(p1, p2, simplex)
        if np.linalg.norm(np.cross(simplex[1] - simplex[0], simplex[2] - simplex[1])) < 1e-8:
            return OracleResult(hit=False)
        if abs(dist_pf_sign(simplex[3], simplex[:3])) < 1e-8:
            return OracleResult(hit=False)
        if point_in_simplex(O, simplex):
            return _epa(p1, p2, simplex, version, tol_ff)
        is_over = all(
            np.all(np.abs(simplex[i] - last1[i]) < 1e-8)
            or np.all(np.abs(simplex[i] - last2[i]) < 1e-8)
            for i in range(4)
        )
        if is_over:
            return OracleResult(hit=False)


# ---------------------------------------------------------------------------
# EPA (ref :242-346, :863-1022)
# ---------------------------------------------------------------------------

def _quickhull_faces(pts):
    if ConvexHull is None:
        raise OracleHalt("scipy unavailable")
    try:
        h = ConvexHull(pts, qhull_options="Qt")
    except (QhullError, ValueError) as e:
        raise OracleHalt(f"QuickHull failed: {e}") from e
    return pts[h.simplices]


def _unique_rows(pts):
    """getHullMeshesVertex: face soup -> unique vertex list (exact dedup)."""
    seen = []
    for row in pts:
        if not any(np.array_equal(row, s) for s in seen):
            seen.append(row)
    return np.stack(seen)


def _update_epa(p1, p2, poly1):
    dist1 = np.array([abs(dist_pf_sign(O, f)) for f in poly1])
    k = int(np.argmin(dist1))
    min_val = float(np.min(dist1))
    d = uninml(poly1[k])
    dot = np.dot(poly1[k, 0] - O, d)
    if abs(dot) < 1e-12:
        m = poly1.reshape(-1, 3).mean(axis=0)
        dot = np.dot(poly1[k, 0] - m, d)
    if dot <= -1e-12:
        d = -d

    spmp = support_mapping(p1, p2, d)
    scat = _unique_rows(poly1.reshape(-1, 3))
    scat = np.vstack([scat, spmp])
    if abs(min_val) < 1e-12:
        scat = np.vstack([scat, support_mapping(p1, p2, -d)])

    poly2 = _quickhull_faces(scat)
    dist2 = np.array([abs(dist_pf_sign(O, f)) for f in poly2])
    k2 = int(np.argmin(dist2))
    min_val2 = float(np.min(dist2))
    d2 = uninml(poly2[k2])
    if np.dot(poly2[k2, 0] - O, d2) < 0.0:
        d2 = -d2

    if len(dist1) == len(dist2):
        if np.all(np.abs(np.sort(dist1) - np.sort(dist2)) < 1e-8):
            return False, poly2, min_val2, d2
        return True, poly2, 0.0, np.zeros(3)
    if len(dist1) > len(dist2):  # QuickHull merged a duplicate support
        return False, poly2, min_val2, d2
    return True, poly2, 0.0, np.zeros(3)


def _epa(p1, p2, simplex, version, tol_ff):
    poly = np.stack([
        simplex[[0, 1, 2]], simplex[[0, 2, 3]],
        simplex[[0, 1, 3]], simplex[[1, 2, 3]],
    ])
    it = 0
    while True:
        it += 1
        if it > 99:
            # ref: WRITE + PAUSE, outputs stay zeroed (:299-303)
            return OracleResult(hit=True, epa_capped=True)
        is_exp, poly, depth, nml = _update_epa(p1, p2, poly)
        if not is_exp:
            break

    nearest = _nearest_points(p1, p2, nml)
    if version == 1:
        point = _collision_point_01(p1, p2, nml)
    elif version == 2:
        point = _collision_point_02(p1, p2, nml)
    elif version == 3:
        point, nml = _collision_point_03(p1, p2, nml)
    else:
        raise OracleHalt("unknown version (ref :337-339)")
    ctype = _collision_type(p1, p2, nml, tol_ff)
    return OracleResult(hit=True, colli_type=ctype, nearest_points=nearest,
                        normal=nml, contact_point=point, depth=depth)


# ---------------------------------------------------------------------------
# contact derivation (ref :353-855)
# ---------------------------------------------------------------------------

def _nearest_points(p1, p2, nml):
    i1 = int(np.argmax(p1 @ nml))
    i2 = int(np.argmax(p2 @ -nml))
    return np.stack([p1[i1], p2[i2]])


def _collision_type(p1, p2, nml, tol):
    c = int(np.sum(p1 @ nml > np.max(p1 @ nml) - tol))
    d = int(np.sum(p2 @ -nml > np.max(p2 @ -nml) - tol))
    return 2 if (c >= 3 and d >= 3) else 1


def _sloppy_top2(p, d):
    max_dot, i1, i2 = -np.inf, -1, -1
    dots = p @ d
    for i in range(len(p)):
        if dots[i] > max_dot - 1e-8:
            max_dot = dots[i]
            i2 = i1
            i1 = i
    if i2 < 0:
        i2 = i1
    return i1, i2


def _collision_point_01(p1, p2, nml):
    a1, a2 = _sloppy_top2(p1, nml)
    b1, b2 = _sloppy_top2(p2, -nml)
    if a1 == a2 and b1 == b2:
        return (p1[a1] + p2[b1]) / 2.0
    if a1 != a2 and b1 == b2:
        return p2[b1].copy()
    if a1 == a2 and b1 != b2:
        return p1[a1].copy()
    dots = p1 @ nml
    sel = dots > np.max(dots) - 1e-1
    return p1[sel].mean(axis=0)


def _collision_point_02(p1, p2, nml):
    d1 = p1 @ nml
    d2 = p2 @ -nml
    s1 = p1[d1 > np.max(d1) - 1e-1]
    s2 = p2[d2 > np.max(d2) - 1e-1]
    n1, n2 = len(s1), len(s2)

    def case_04(poly, edge):
        poly_sorted = sort_clock(poly)
        c = sum(bool(is_inside_pf(poly_sorted, e)) for e in edge)
        if c == 0:
            return foot_pl(poly.mean(axis=0), edge)
        if c in (1, 2):
            return (edge[0] + edge[1]) / 2.0
        raise OracleHalt("branch_case_04 impossible count (ref :635-637)")

    if n1 == 1 and n2 == 1:
        return (s1[0] + s2[0]) / 2.0
    if n1 == 1 and n2 >= 2:
        return s1[0].copy()
    if n1 >= 2 and n2 == 1:
        return s2[0].copy()
    if n1 == 2 and n2 == 2:
        feet = foot_ll(s1[:2], s2[:2])
        return (feet[0] + feet[1]) / 2.0
    if n1 == 2 and n2 >= 3:
        return case_04(s2, s1[:2])
    if n1 >= 3 and n2 == 2:
        return case_04(s1, s2[:2])
    if n1 >= 3 and n2 >= 3:
        return s1.mean(axis=0)
    raise OracleHalt("get_collisionPoint_02 fall-through (ref :499-501)")


def _collision_point_03(p1, p2, nml):
    max_dot, idx = -np.inf, 0
    dots = p2 @ -nml
    for i in range(len(p2)):
        if dots[i] > max_dot - 1e-8:
            max_dot = dots[i]
            idx = i
    point = p2[idx].copy()
    point[2] = p1[:, 2].mean()
    new_nml = nml.copy()
    new_nml[2] = 0.0
    new_nml = new_nml / np.linalg.norm(new_nml)
    return point, new_nml


# ---------------------------------------------------------------------------
# exact geometry, independent of the reference's control flow
# ---------------------------------------------------------------------------

def _segment_distances(a, b):
    """Distance from the origin to each segment [a_k, b_k] (rows)."""
    e = b - a
    t = np.clip(-np.einsum("ij,ij->i", a, e)
                / np.maximum(np.einsum("ij,ij->i", e, e), 1e-300), 0.0, 1.0)
    return np.linalg.norm(a + t[:, None] * e, axis=1)


def signed_distance_oracle(p1, p2):
    """Signed separation of two convex vertex clouds from the hull of their
    Minkowski difference {a_i - b_j}: the Euclidean distance from the
    origin to the hull when the clouds are apart (> 0), minus the
    penetration depth when they overlap (< 0, the smallest face-plane
    clearance of the interior origin).  Float64, qhull plus closed-form
    point-triangle distances; shares no code with the engine or with the
    transliterated oracle above."""
    diff = (np.asarray(p1, np.float64)[:, None, :]
            - np.asarray(p2, np.float64)[None, :, :]).reshape(-1, 3)
    hull = ConvexHull(diff)
    offsets = hull.equations[:, 3]             # n.x + offset <= 0 inside
    if np.all(offsets <= 0.0):
        return float(np.max(offsets))          # -(min clearance)
    tri = diff[hull.simplices]                 # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    foot = np.einsum("ij,ij->i", a, n)[:, None] * n   # origin's projection
    inside = np.ones(len(tri), bool)
    for u, v in ((a, b), (b, c), (c, a)):      # same side of every edge
        inside &= np.einsum("ij,ij->i", np.cross(v - u, foot - u), n) >= 0.0
    plane = np.where(inside, np.abs(np.einsum("ij,ij->i", a, n)), np.inf)
    edges = np.minimum.reduce([_segment_distances(a, b),
                               _segment_distances(b, c),
                               _segment_distances(c, a)])
    return float(np.min(np.minimum(plane, edges)))
