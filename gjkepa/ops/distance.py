"""Distance-GJK: closest distance + witness points for separated pairs.

Capability extension (SURVEY.md §3.2): the reference's GJK decides misses
purely by stagnation heuristics and never produces a distance certificate —
``nearest_points_`` stays zero on a miss.  Bench config c2 asks for
"boolean GJK + closest distance", so this module implements the classical
distance GJK with simplex reduction, re-designed fixed-shape:

  * the simplex is a padded (4,3) buffer + count;
  * "closest point on the simplex to the origin" is solved by brute
    enumeration of all 15 sub-simplices (4 vertices, 6 edges, 4 triangles,
    1 tetra) — each candidate is a tiny closed-form projection, all are
    computed unconditionally and the best VALID one selected, in place of
    branchy Johnson/Voronoi case trees: ~100 fused flops, no divergence
    across a batch;
  * the carry also tracks per-vertex witness pairs (a_i, b_i) so the
    closest points on A and B are recovered from the same barycentrics.

Convergence: relative duality-gap test |v|^2 - <v, w> <= eps*|v|^2 plus a
no-progress guard; intersecting pairs exit with distance 0.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp
from jax import lax

from ..config import GJKEPAConfig

__all__ = ["DistanceResult", "gjk_distance"]

# All sub-simplices of {0,1,2,3} by size, padded with -1.
_SUBSETS = (
    [[0, -1, -1, -1], [1, -1, -1, -1], [2, -1, -1, -1], [3, -1, -1, -1]],
    [[0, 1, -1, -1], [0, 2, -1, -1], [0, 3, -1, -1],
     [1, 2, -1, -1], [1, 3, -1, -1], [2, 3, -1, -1]],
    [[0, 1, 2, -1], [0, 1, 3, -1], [0, 2, 3, -1], [1, 2, 3, -1]],
    [[0, 1, 2, 3]],
)


class DistanceResult(NamedTuple):
    distance: jnp.ndarray   # () closest distance (0 if intersecting)
    point_a: jnp.ndarray    # (3,) witness on A
    point_b: jnp.ndarray    # (3,) witness on B
    intersecting: jnp.ndarray  # bool
    iters: jnp.ndarray      # int32


def _closest_point_candidates(pts, n_pts, big):
    """Closest point to origin on each sub-simplex of pts[:4].

    Returns (dist2, bary(4,)) for all 15 candidates; invalid candidates
    (using vertices >= n_pts, or with out-of-range barycentrics for the
    unclamped face/tetra projections) get dist2 = big.  Edges/vertices use
    clamped projections so at least one candidate is always valid.
    """
    cands_d, cands_b = [], []

    def emit(d2, bary, valid):
        cands_d.append(jnp.where(valid, d2, big))
        cands_b.append(bary)

    # vertices
    for i in range(4):
        d2 = jnp.dot(pts[i], pts[i])
        bary = jnp.zeros(4, pts.dtype).at[i].set(1.0)
        emit(d2, bary, i < n_pts)

    # edges (clamped segment projection)
    for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        a, b = pts[i], pts[j]
        ab = b - a
        denom = jnp.dot(ab, ab)
        t = jnp.clip(jnp.dot(-a, ab) / jnp.where(denom > 0, denom, 1.0), 0.0, 1.0)
        p = a + t * ab
        bary = jnp.zeros(4, pts.dtype).at[i].set(1.0 - t).at[j].set(t)
        emit(jnp.dot(p, p), bary, (j < n_pts) & (denom > 0))

    # triangles (plane projection, valid iff inside)
    for i, j, k in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
        a, b, c = pts[i], pts[j], pts[k]
        n = jnp.cross(b - a, c - a)
        nn = jnp.dot(n, n)
        safe = jnp.where(nn > 0, nn, 1.0)
        # projection of origin onto plane: p = a + ... ; barycentrics via areas
        dist_plane = jnp.dot(a, n) / safe  # signed, scaled
        p = dist_plane * n
        # barycentric coordinates of p in (a,b,c)
        v0, v1, v2 = b - a, c - a, p - a
        d00, d01, d11 = jnp.dot(v0, v0), jnp.dot(v0, v1), jnp.dot(v1, v1)
        d20, d21 = jnp.dot(v2, v0), jnp.dot(v2, v1)
        den = d00 * d11 - d01 * d01
        dsafe = jnp.where(jnp.abs(den) > 0, den, 1.0)
        v = (d11 * d20 - d01 * d21) / dsafe
        w = (d00 * d21 - d01 * d20) / dsafe
        u = 1.0 - v - w
        inside = (u >= 0) & (v >= 0) & (w >= 0) & (jnp.abs(den) > 0)
        bary = jnp.zeros(4, pts.dtype).at[i].set(u).at[j].set(v).at[k].set(w)
        emit(jnp.dot(p, p), bary, (k < n_pts) & inside)

    # tetra interior (origin inside -> distance 0).  Solve [e0 e1 e2] l = -a
    # by Cramer's rule — no LU, just cross/dot (f64-safe).
    a, b, c, d = pts[0], pts[1], pts[2], pts[3]
    e0, e1, e2 = b - a, c - a, d - a
    det = jnp.dot(jnp.cross(e0, e1), e2)
    dsafe = jnp.where(jnp.abs(det) > 0, det, 1.0)
    rhs = -a
    l0 = jnp.dot(jnp.cross(rhs, e1), e2) / dsafe
    l1 = jnp.dot(jnp.cross(e0, rhs), e2) / dsafe
    l2 = jnp.dot(jnp.cross(e0, e1), rhs) / dsafe
    lam = jnp.stack([l0, l1, l2])
    u = 1.0 - lam.sum()
    inside = (u >= 0) & jnp.all(lam >= 0) & (jnp.abs(det) > 0)
    bary = jnp.concatenate([u[None], lam])
    emit(jnp.zeros((), pts.dtype), bary, (n_pts >= 4) & inside)

    return jnp.stack(cands_d), jnp.stack(cands_b)


# candidate index -> sub-simplex vertex list (padded -1), matching emit order.
# Plain numpy: module constants must not be traced arrays (a lazy import
# under jit would otherwise capture tracers in module globals).
import numpy as _np  # noqa: E402

_CAND_VERTS = _np.array([s for group in _SUBSETS for s in group], dtype=_np.int32)
_CAND_SIZE = _np.array([1] * 4 + [2] * 6 + [3] * 4 + [4], dtype=_np.int32)


def gjk_distance(support: Callable, cfg: GJKEPAConfig, dtype=jnp.float32,
                 max_iters: int = 64, active: jnp.ndarray | bool = True) -> DistanceResult:
    """Closest distance between two convex sets via their Minkowski support."""
    active = jnp.asarray(active)
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    eps_rel = 1e-12 if dtype == jnp.float64 else 1e-6

    # seed with one support point
    r0 = support(jnp.asarray([1.0, 0.0, 0.0], dtype))
    w = jnp.zeros((4, 3), dtype).at[0].set(r0.w)
    wa = jnp.zeros((4, 3), dtype).at[0].set(r0.a)
    wb = jnp.zeros((4, 3), dtype).at[0].set(r0.b)

    def cond(c):
        return ~c["done"] & (c["iter"] < max_iters)

    def body(c):
        w, wa, wb, n = c["w"], c["wa"], c["wb"], c["n"]
        d2s, barys = _closest_point_candidates(w, n, big)
        k = jnp.argmin(d2s)
        bary = barys[k]
        v = bary @ w                      # closest point on simplex to origin
        pa = bary @ wa
        pb = bary @ wb
        v2 = jnp.dot(v, v)
        intersecting = v2 < eps_rel

        # reduce simplex to the supporting sub-simplex (compact to front)
        sub = jnp.asarray(_CAND_VERTS)[k]
        size = jnp.asarray(_CAND_SIZE)[k]
        idx = jnp.where(sub >= 0, sub, 0)
        w_new = w[idx]
        wa_new = wa[idx]
        wb_new = wb[idx]

        # new support toward the origin
        r = support(-v)
        gap = v2 - jnp.dot(v, r.w)        # duality gap
        converged = intersecting | (gap <= eps_rel * jnp.maximum(v2, 1.0))
        # also stop if the new point is already in the simplex
        dup = jnp.any(
            (jnp.arange(4) < size)
            & jnp.all(jnp.abs(w_new - r.w) < cfg.eps_coincide, axis=1)
        )
        done = converged | dup

        ins = jnp.clip(size, 0, 3)
        w_new = w_new.at[ins].set(r.w)
        wa_new = wa_new.at[ins].set(r.a)
        wb_new = wb_new.at[ins].set(r.b)
        n_new = jnp.minimum(size + 1, 4)

        return {
            "w": jnp.where(done, w, w_new),
            "wa": jnp.where(done, wa, wa_new),
            "wb": jnp.where(done, wb, wb_new),
            "n": jnp.where(done, n, n_new),
            "iter": c["iter"] + 1,
            "done": done,
            "dist2": v2, "pa": pa, "pb": pb, "inter": intersecting,
        }

    init = {
        "w": w, "wa": wa, "wb": wb, "n": jnp.int32(1),
        "iter": jnp.int32(0), "done": ~active,
        "dist2": jnp.zeros((), dtype), "pa": jnp.zeros(3, dtype),
        "pb": jnp.zeros(3, dtype), "inter": jnp.asarray(False),
    }
    out = lax.while_loop(cond, body, init)
    dist = jnp.sqrt(jnp.maximum(out["dist2"], 0.0))
    inter = out["inter"]
    return DistanceResult(
        distance=jnp.where(inter, jnp.zeros((), dtype), dist),
        point_a=out["pa"], point_b=out["pb"],
        intersecting=inter, iters=out["iter"],
    )
