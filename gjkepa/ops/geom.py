"""L1 math kernel: pure 3-D geometry primitives.

JAX re-derivations of the reference's private math tools
(``/root/reference/src/GCLIB_GJKEPA.f90:1193-1689``, components M1-M12 in
SURVEY.md §2.1).  Every function is pure, fixed-shape, dtype-generic and
vmap-safe; none allocates dynamically.  Where the reference halts on
degenerate input (interactive STOP, e.g. :1369-1373) we instead return a
well-defined value (zero) and let callers classify the query via status
codes — a batched device program can never pause.

Epsilons are passed in (or taken from GJKEPAConfig) rather than hard-coded,
but default to the reference's float64 ladder (SURVEY.md §2.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "cross3",
    "counting_argsort",
    "utzvec",
    "uninml",
    "dist_pf_sign",
    "vec_pl",
    "foot_pl",
    "foot_ll",
    "is_inside_pf",
    "point_in_simplex",
    "overlap",
    "sort_clock_indices",
    "SIMPLEX_FACES",
]


def cross3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """3-D cross product (CROSS_PRODUCT_3D, ref :1201-1212)."""
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def utzvec(v: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Safe normalize: zero vector if ||v|| < eps (UTZVEC, ref :1343-1352)."""
    n = jnp.linalg.norm(v)
    return jnp.where(n < eps, jnp.zeros_like(v), v / jnp.where(n < eps, 1.0, n))


def uninml(tri: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Unit normal of the plane through 3 points (UNINML, ref :1382-1394).

    Returns the zero vector when the cross product is degenerate.  The
    reference's test is component-wise (``ANY(|cross| > 1e-12)``, :1392),
    reproduced here exactly.
    """
    n1 = tri[1] - tri[0]
    n2 = tri[2] - tri[1]
    c = cross3(n1, n2)
    ok = jnp.any(jnp.abs(c) > eps)
    nrm = jnp.linalg.norm(c)
    return jnp.where(ok, c / jnp.where(ok, nrm, 1.0), jnp.zeros_like(c))


def dist_pf_sign(point: jnp.ndarray, tri: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Signed point-plane distance (DIST_PF_SIGN, ref :1357-1377).

    The reference STOPs interactively when the 3 points do not define a
    plane (:1369-1373); here a degenerate plane yields distance 0, which
    callers classify as a degenerate/miss branch — the same observable
    outcome as the reference's "this cannot continue" semantics.
    """
    n = uninml(tri, eps)
    return jnp.dot(point - tri[0], n)


def vec_pl(point: jnp.ndarray, line: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Unit vector from `point` toward its foot on `line` (VEC_PL, ref :1423-1440).

    Note the reference's orientation: ``res = UTZVEC(D - C)`` where C is the
    point and D the foot — i.e. it points from the query point TOWARD the
    line, which is how the GJK init phase aims its third support direction
    (ref :116).  Reproduced as-is.
    """
    a, b = line[0], line[1]
    ab = b - a
    ac = point - a
    nrm = jnp.linalg.norm(ab)
    safe = jnp.where(nrm < eps, 1.0, nrm)
    foot = a + (jnp.dot(ac, ab) / safe) * (ab / safe)
    return utzvec(foot - point, eps)


def foot_pl(point: jnp.ndarray, line: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Foot of perpendicular from point to line (FOOT_PL, ref :1492-1505)."""
    u = utzvec(line[1] - line[0], eps)
    return line[0] + jnp.dot(point - line[0], u) * u


def foot_ll(line1: jnp.ndarray, line2: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closest points between two 3-D lines (FOOT_LL, ref :1446-1487).

    Returns (2,3): one point on each line.  Parallel lines fall back to the
    midpoint of line1 plus its foot on line2 (:1474-1476).
    """
    p1, q1 = line1[0], line1[1]
    p2, q2 = line2[0], line2[1]
    d1, d2 = q1 - p1, q2 - p2
    r = p1 - p2
    a = jnp.dot(d1, d1)
    b = jnp.dot(d1, d2)
    c = jnp.dot(d1, r)
    e = jnp.dot(d2, d2)
    f = jnp.dot(d2, r)
    d = a * e - b * b
    parallel = jnp.abs(d) < eps
    safe_d = jnp.where(parallel, 1.0, d)
    s = (b * f - c * e) / safe_d
    t = (a * f - b * c) / safe_d
    skew = jnp.stack([p1 + s * d1, p2 + t * d2])
    mid1 = (p1 + q1) * 0.5
    par = jnp.stack([mid1, foot_pl(mid1, line2, eps)])
    return jnp.where(parallel, par, skew)


def _polygon_crosses(xs, ys, px, py, valid, n_valid):
    """Cyclic edge crosses of a front-compacted planar polygon projection."""
    k = xs.shape[0]
    idx = jnp.arange(k)
    nxt = jnp.where(idx + 1 >= n_valid, 0, idx + 1)
    # cyclic successor via one-hot contraction
    onehot = (nxt[:, None] == idx[None, :]).astype(xs.dtype)
    xs_n = onehot @ xs
    ys_n = onehot @ ys
    c = (xs_n - xs) * (py - ys) - (ys_n - ys) * (px - xs)
    return jnp.where(valid, c, 0.0)


def is_inside_pf(
    verts: jnp.ndarray,
    point: jnp.ndarray,
    n_valid: jnp.ndarray | int | None = None,
    eps_zero: float = 1e-12,
) -> jnp.ndarray:
    """Point-in-planar-polygon test (IS_INSIDE_PF, ref :1271-1337).

    `verts` is (K,3) with the first `n_valid` rows holding the polygon in
    order (front-compacted); the rest are padding.  Semantics replicated
    exactly from the reference:

      * edge crosses are computed on the XOY projection (:1289-1298);
      * results with |c| < 1e-12 are clamped to zero (:1301);
      * if NO cross exceeds +1e-15 — including the all-negative case! —
        the test is redone on the XOZ projection (:1305-1322);
      * the point is outside iff any cross has strictly opposite sign to
        the first vertex's cross (:1326-1333).
    """
    k = verts.shape[0]
    if n_valid is None:
        n_valid = k
    n_valid = jnp.asarray(n_valid)
    valid = jnp.arange(k) < n_valid

    cxy = _polygon_crosses(verts[:, 0], verts[:, 1], point[0], point[1], valid, n_valid)
    cxy = jnp.where(jnp.abs(cxy) < eps_zero, 0.0, cxy)
    use_xz = ~jnp.any(cxy > 1e-15)
    cxz = _polygon_crosses(verts[:, 0], verts[:, 2], point[0], point[2], valid, n_valid)
    c = jnp.where(use_xz, cxz, cxy)
    # Outside iff a strict sign flip vs the first element exists (zeros neutral).
    flips = (c[0] * c) < 0.0
    return ~jnp.any(jnp.where(valid, flips, False))


# Face index table of the always-4-vertex simplex (ref idFc, :1227-1229):
# face1=[1,3,4], face2=[1,2,4], face3=[1,2,3], face4=[2,3,4]  (1-based).
# Vertex i lies on face i, which the reference exploits for orientation.
import numpy as _np  # noqa: E402

SIMPLEX_FACES_NP = _np.array([[0, 2, 3], [0, 1, 3], [0, 1, 2], [1, 2, 3]],
                             dtype=_np.int32)
SIMPLEX_FACES = jnp.array(SIMPLEX_FACES_NP)


def point_in_simplex(p: jnp.ndarray, simplex: jnp.ndarray, eps_coincide: float = 1e-8,
                     eps_zero: float = 1e-12) -> jnp.ndarray:
    """Point-in-tetrahedron with on-face fallback (isPointInSimplex, ref :1217-1265).

    Outward face normals are fixed against the tetra centroid; the point is
    inside iff all signed distances are strictly positive, OR it lies on a
    face plane (|dist| < 1e-8) and passes the 2-D polygon test on that face.
    """
    m = jnp.mean(simplex, axis=0)

    # statically unrolled over the 4 faces: all indices constant, so XLA
    # emits slices instead of dynamic gathers
    dists, on_face = [], []
    for i in range(4):
        f0, f1, f2 = (int(x) for x in SIMPLEX_FACES_NP[i])
        a, b, c = simplex[f0], simplex[f1], simplex[f2]
        nml = utzvec(cross3(a - b, b - c), eps_zero)
        nml = jnp.where(jnp.dot(nml, simplex[i] - m) < 0.0, -nml, nml)
        dist = jnp.dot(simplex[i] - p, nml)
        on_plane = jnp.abs(dist) < eps_coincide
        inside2d = is_inside_pf(jnp.stack([a, b, c]), p, eps_zero=eps_zero)
        dists.append(dist)
        on_face.append(on_plane & inside2d)
    dists = jnp.stack(dists)
    on_face = jnp.stack(on_face)
    return jnp.any(on_face) | jnp.all(dists > 0.0)


def overlap(points: jnp.ndarray, valid: jnp.ndarray | None = None,
            eps: float = 1e-12) -> jnp.ndarray:
    """True iff all (valid) points coincide within eps (OVERLAP, ref :1399-1418)."""
    if valid is None:
        valid = jnp.ones(points.shape[0], dtype=bool)
    ref = points[0]
    diff = jnp.abs(points - ref) > eps
    return ~jnp.any(jnp.where(valid[:, None], diff, False))


def counting_argsort(x: jnp.ndarray) -> jnp.ndarray:
    """Stable argsort of a small 1-D array by rank counting.

    O(n^2) vectorized compares instead of a sort network, for the
    n <= ~128 arrays used here (support sets, polytope slots).
    """
    n = x.shape[0]
    idx = jnp.arange(n)
    lt = x[None, :] < x[:, None]
    eq_before = (x[None, :] == x[:, None]) & (idx[None, :] < idx[:, None])
    rank = jnp.sum(lt | eq_before, axis=1)          # unique ranks, stable
    return jnp.argmax(rank[None, :] == idx[:, None], axis=1)


def sort_clock_indices(points: jnp.ndarray, n_valid: jnp.ndarray | int) -> jnp.ndarray:
    """Counter-clockwise angular order of front-compacted coplanar points
    (SORT_CLOCK, ref :1513-1575), returned as a permutation index array.

    The reference's greedy min-relative-angle chain starting at point 0 is
    equivalent to sorting by the CCW angle from point 0 around the centroid
    (same atan2 formulation, :1544-1547), which is what we compute.  If all
    valid points coincide the input order is returned (:1521).
    """
    k = points.shape[0]
    n_valid = jnp.asarray(n_valid)
    valid = jnp.arange(k) < n_valid
    nf = jnp.maximum(n_valid, 1).astype(points.dtype)
    centroid = jnp.sum(jnp.where(valid[:, None], points, 0.0), axis=0) / nf
    normal = cross3(points[1] - points[0], points[2] - points[0])
    v0 = points[0] - centroid
    v = points - centroid
    # CCW angle of each point from point 0 (ref formula, order-preserving
    # even though `normal` is unnormalized).
    y = v @ cross3(normal, v0)  # dot(normal, cross(v0, vj)) == dot(vj, normal x v0)
    x = v @ v0
    two_pi = 2.0 * jnp.pi
    ang = jnp.mod(jnp.arctan2(y, x) + two_pi, two_pi)
    ang = ang.at[0].set(-1.0)  # point 0 always first
    ang = jnp.where(valid, ang, jnp.inf)  # padding last
    order = counting_argsort(ang)
    same = overlap(points, valid)
    return jnp.where(same, jnp.arange(k), order)
