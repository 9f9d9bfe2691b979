"""L3b: EPA penetration-depth core (incremental capped-face polytope).

The reference's EPA (``/root/reference/src/GCLIB_GJKEPA.f90:242-346`` driver,
``:863-1022`` expansion step) rebuilds a convex hull from scratch every
iteration: polytope -> unique-vertex scatter (getHullMeshesVertex, :920) ->
append support -> QuickHull (:950) -> O(F^2) bubble-sorted distance compare
for convergence (:975-1003).  That is its biggest inefficiency and is
hostile to fixed-shape compilation, so the mechanism is re-derived
(SURVEY.md §7.4) while preserving the observable contract — penetration
depth = distance of the closest polytope face to the origin, normal = that
face's outward normal (:994-1009):

  * the polytope lives in preallocated arrays: ``verts (V,3)`` with a count,
    ``faces (F,3)`` vertex-index triples with an alive mask;
  * each iteration picks the alive face closest to the origin, probes the
    support map along its outward normal, and either converges (the support
    adds < eps beyond the face — observably equivalent to the reference's
    "sorted face distances stopped changing within 1e-8" test) or stitches
    the new vertex in over the horizon;
  * the horizon is found without pointer chasing: a pairwise undirected-
    edge-key match (vectorized compares instead of a scatter table) marks
    edges with exactly one visible adjacent face; winding-free because
    normals are re-oriented against the
    polytope centroid each iteration (mirroring the reference's centroid
    orientation fix for on-face origins, :902-910);
  * the reference's touching-contact double support injection (:934-944)
    is unnecessary here: the seed tetra always has volume (the GJK init
    path guarantees it), so the polytope never degenerates to a plane.

Iteration cap (99, ref :299) maps to ``Status.HIT_EPA_CAP`` instead of the
reference's interactive PAUSE + zeroed outputs; depth/normal then carry the
current best estimate.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import GJKEPAConfig
from ..types import Status

__all__ = ["EPAResult", "run_epa"]

# Seed polytope: the 4 triangular faces of the GJK simplex, exactly the
# reference's seeding (ref :279-293): (1,2,3),(1,3,4),(1,2,4),(2,3,4).
_SEED_FACES = jnp.array([[0, 1, 2], [0, 2, 3], [0, 1, 3], [1, 2, 3]], dtype=jnp.int32)


class EPAResult(NamedTuple):
    depth: jnp.ndarray    # () penetration depth
    normal: jnp.ndarray   # (3,) contact normal, points from A toward B
    #                       (translating B by depth*normal separates the pair)
    iters: jnp.ndarray    # int32 expansion iterations used
    status: jnp.ndarray   # int32 Status (HIT / HIT_EPA_CAP / HIT_EPA_DEGENERATE)


def _take_rows(table, idx):
    """Batched row gather as a one-hot matmul.

    A (K, V) one-hot times (V, 3) contraction at HIGHEST precision copies
    the rows exactly; whether a gather is faster on the GPU is open
    (ROADMAP queue 3).
    """
    onehot = (idx[:, None] == jnp.arange(table.shape[0])[None, :])
    return onehot.astype(table.dtype) @ table


def _face_geometry(verts, faces, alive, n_verts, eps_zero):
    """Outward unit normals and origin distances of alive faces.

    Orientation is fixed against the polytope centroid (ref :902-910) so
    on-boundary origins are handled; degenerate (zero-area) faces are
    masked out.
    """
    vmask = (jnp.arange(verts.shape[0]) < n_verts)[:, None]
    nf = jnp.maximum(n_verts, 1).astype(verts.dtype)
    centroid = jnp.sum(jnp.where(vmask, verts, 0.0), axis=0) / nf

    a = _take_rows(verts, faces[:, 0])
    b = _take_rows(verts, faces[:, 1])
    c = _take_rows(verts, faces[:, 2])
    n = jnp.cross(b - a, c - a)
    nrm = jnp.linalg.norm(n, axis=1)
    ok = alive & (nrm > eps_zero)
    n = n / jnp.where(nrm > eps_zero, nrm, 1.0)[:, None]
    outward = jnp.einsum("fi,fi->f", n, a - centroid[None, :]) >= 0.0
    n = jnp.where(outward[:, None], n, -n)
    dist = jnp.einsum("fi,fi->f", n, a)  # plane distance from origin
    return n, jnp.where(ok, dist, jnp.inf), ok


def run_epa(
    support: Callable,
    simplex: jnp.ndarray,
    active: jnp.ndarray,
    cfg: GJKEPAConfig,
) -> EPAResult:
    """Expand the polytope from `simplex` until the closest face is on the
    Minkowski-difference boundary.  `active=False` lanes exit immediately
    (their whole while-loop body retires in the first batched iteration).
    """
    dtype = simplex.dtype
    V = cfg.epa_max_verts
    F = cfg.epa_max_faces
    eps = cfg.eps_coincide

    verts0 = jnp.zeros((V, 3), dtype=dtype).at[:4].set(simplex)
    faces0 = jnp.zeros((F, 3), dtype=jnp.int32).at[:4].set(_SEED_FACES)
    alive0 = jnp.zeros((F,), dtype=bool).at[:4].set(True)

    def cond(c):
        return ~c["done"] & (c["iter"] < cfg.epa_max_iters)

    def body(c):
        verts, faces, alive, n_verts = c["verts"], c["faces"], c["alive"], c["n_verts"]
        normals, dists, ok = _face_geometry(verts, faces, alive, n_verts, cfg.eps_zero)
        all_degenerate = ~jnp.any(ok)
        f_star = jnp.argmin(dists)
        star_onehot = jnp.arange(F) == f_star
        d_min_raw = jnp.min(dists)
        dir_raw = jnp.sum(jnp.where(star_onehot[:, None], normals, 0.0), axis=0)
        d_min = jnp.where(all_degenerate, jnp.asarray(0.0, dtype), d_min_raw)
        direction = jnp.where(all_degenerate, jnp.zeros(3, dtype), dir_raw)

        w = support(direction).w
        gain = jnp.dot(w, direction) - d_min
        vmask = jnp.arange(V) < n_verts
        dup = jnp.any(vmask & jnp.all(jnp.abs(verts - w) < eps, axis=1))
        converged = (gain < eps) | dup

        # --- horizon extraction ------------------------------------------
        visible = ok & (jnp.einsum("fi,i->f", normals, w) > dists + cfg.eps_zero)
        visible = visible | (jnp.arange(F) == f_star)  # f* always visible
        visible = visible & alive

        u = jnp.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
        v = jnp.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
        evis = jnp.concatenate([visible, visible, visible])
        # Undirected-edge occurrence count among visible edges via a pairwise
        # key match: O(E^2) vectorized compares instead of a scatter table.
        ukey = jnp.where(evis, jnp.minimum(u, v) * V + jnp.maximum(u, v), -1)
        cnt = jnp.sum(ukey[:, None] == ukey[None, :], axis=1)
        horizon = evis & (cnt == 1)

        n_new = jnp.sum(horizon)
        free = ~alive | visible
        n_free = jnp.sum(free)
        cant_expand = (~converged) & (
            (n_new > n_free) | (n_verts >= V) | (n_new == 0) | all_degenerate
        )
        do_insert = ~(converged | cant_expand)

        # --- masked insertion: r-th horizon edge -> r-th free slot --------
        # GATHER formulation (no scatter): each slot computes its own rank
        # among free slots and binary-searches the horizon-edge cumsum for
        # the matching source edge.  Cumulative counts come from
        # constant-triangular matmuls (exact in HIGHEST precision: the
        # counts stay far below 2^24).
        tri_f = jnp.tril(jnp.ones((F, F), dtype))
        tri_e = jnp.tril(jnp.ones((3 * F, 3 * F), dtype))
        rank_f = (tri_f @ free.astype(dtype)).astype(jnp.int32) - 1   # (F,)
        chor = (tri_e @ horizon.astype(dtype)).astype(jnp.int32)      # (3F,)
        # searchsorted-left(chor, r+1) == #(chor < r+1): a compare-count,
        # which vectorizes cleanly where searchsorted's scan does not.
        src_edge = jnp.sum(chor[None, :] < (rank_f[:, None] + 1), axis=1)
        src_edge = jnp.clip(src_edge, 0, 3 * F - 1)
        write_slot = free & (rank_f < n_new) & do_insert
        # int gather via one-hot dot (values < 3F << 2^24, exact in f32)
        src_onehot = (src_edge[:, None] == jnp.arange(3 * F)[None, :]).astype(dtype)
        uu = (src_onehot @ u.astype(dtype)).astype(jnp.int32)
        vv = (src_onehot @ v.astype(dtype)).astype(jnp.int32)
        new_face = jnp.stack([uu, vv, jnp.full_like(uu, n_verts)], axis=1)  # (F,3)
        faces_new = jnp.where(write_slot[:, None], new_face, faces)
        alive_new = jnp.where(do_insert, (alive & ~visible) | write_slot, alive)
        verts_new = jnp.where(
            do_insert,
            lax.dynamic_update_slice(verts, w[None, :],
                                     (n_verts, jnp.int32(0))), verts)
        n_verts_new = jnp.where(do_insert, n_verts + 1, n_verts)

        done = converged | cant_expand
        status = jnp.where(
            converged, jnp.int32(Status.HIT),
            jnp.where(cant_expand, jnp.int32(Status.HIT_EPA_DEGENERATE), c["status"]),
        )
        return {
            "verts": verts_new, "faces": faces_new, "alive": alive_new,
            "n_verts": n_verts_new, "iter": c["iter"] + 1, "done": done,
            "depth": d_min,       # current closest-face distance (final on exit)
            "normal": direction,
            "status": status,
        }

    init = {
        "verts": verts0, "faces": faces0, "alive": alive0,
        "n_verts": jnp.int32(4), "iter": jnp.int32(0), "done": ~active,
        "depth": jnp.asarray(0.0, dtype), "normal": jnp.zeros(3, dtype),
        "status": jnp.int32(Status.HIT_EPA_CAP),
    }
    out = lax.while_loop(cond, body, init)

    depth = jnp.where(active, out["depth"], 0.0)
    normal = jnp.where(active, out["normal"], 0.0)
    status = jnp.where(active, out["status"], jnp.int32(0))
    return EPAResult(depth=depth, normal=normal, iters=out["iter"], status=status)


def polish_support_descent(support, depth, normal, ok,
                           rounds: int = 6, spread: float = 0.45,
                           shrink: float = 1.0 / 3.0):
    """Fixed-cost refinement of (depth, normal) for exact support maps.

    Penetration depth = min over unit d of h(d) = <support(d), d>.  A 3x3
    tangent-grid descent from the EPA direction (`rounds` shrinking
    steps) reaches it to ~R*1e-6 where converged f32 EPA on smooth shapes
    stalls at ~1e-3*R — or far worse when the iteration cap bites on deep
    smooth contacts (-0.06 reported vs 0.59 exact on a deep hull-sphere
    pair).

    Single-query form (3-vectors); callers vmap it.  `support(d)` must
    return an object whose `.w` is the Minkowski support point (the
    SupportResult convention).  Lanes with ~ok (miss, or zero normal) pass
    through unchanged."""
    nrm = jnp.linalg.norm(normal)
    ok = ok & (nrm > 0.5)
    small_x = jnp.abs(normal[0]) < 0.9
    helper = jnp.where(small_x, jnp.array([1.0, 0.0, 0.0], normal.dtype),
                       jnp.array([0.0, 1.0, 0.0], normal.dtype))
    u = jnp.cross(normal, helper)
    u = u / jnp.maximum(jnp.linalg.norm(u), 1e-20)
    v = jnp.cross(normal, u)

    def h_at(a, b):
        inv = 1.0 / jnp.sqrt(1.0 + a * a + b * b)
        d = (normal + a * u + b * v) * inv
        return jnp.dot(support(d).w, d), d

    best_h, _ = h_at(jnp.asarray(0.0, normal.dtype),
                     jnp.asarray(0.0, normal.dtype))

    def body(r, c):
        best_h, a0, b0, s = c
        k = r % 8
        k2 = k + jnp.where(k >= 4, 1, 0)
        da = (k2 // 3 - 1).astype(normal.dtype)
        db = (k2 % 3 - 1).astype(normal.dtype)
        aa, bb = a0 + da * s, b0 + db * s
        hh, _ = h_at(aa, bb)
        better = ok & (hh < best_h)
        return (jnp.where(better, hh, best_h), jnp.where(better, aa, a0),
                jnp.where(better, bb, b0),
                jnp.where(k == 7, s * shrink, s))

    z = jnp.asarray(0.0, normal.dtype)
    best_h, a0, b0, _ = lax.fori_loop(
        0, 8 * rounds, body, (best_h, z, z, jnp.asarray(spread,
                                                        normal.dtype)))
    _, d_best = h_at(a0, b0)
    return jnp.where(ok, best_h, depth), jnp.where(ok, d_best, normal)
