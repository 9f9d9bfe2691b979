"""L3c: contact derivation from the EPA normal.

Re-derivations of the reference's contact post-processing
(``/root/reference/src/GCLIB_GJKEPA.f90``):

  * ``get_nearest_points`` (:813-855) — witness vertices along +/-normal;
  * ``get_info_collisionType`` (:353-413) — face-face classification by
    counting support-set sizes against TOL_FF;
  * ``get_collisionPoint_01`` (:700-806) — "experimental" version 1;
  * ``get_collisionPoint_02`` (:457-696) — "general" version 2 with the full
    (n1,n2) support-set case tree;
  * ``get_collisionPoint_03`` (:426-452) — "stator-rotor special" version 3
    (the only version that also rewrites the collision normal).

The reference collects support sets into growable linked lists
(GCLIB_List); here they are fixed-capacity boolean masks over the padded
vertex buffers, front-compacted with a stable argsort where element order
matters (SURVEY.md §2.3).  The five version-2 cases are computed
unconditionally and selected — each is an O(N) reduction, so selection
avoids divergent control flow across a batch (SURVEY.md §7.5).

Version 1 and 3 use a quirky sequential scan whose running max can *drop*
within a 1e-8 slop (:726,741); that scan order is observable (it decides
which vertex index wins), so it is reproduced with a ``lax.fori_loop``
rather than an argmax.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..config import GJKEPAConfig
from .geom import counting_argsort, foot_ll, foot_pl, is_inside_pf, sort_clock_indices

__all__ = [
    "nearest_points",
    "collision_type",
    "collision_point_v1",
    "collision_point_v2",
    "collision_point_v2_sets",
    "collision_point_v3",
]


def _masked_dots(p, mask, d):
    dots = p @ d
    return jnp.where(mask, dots, -jnp.inf) if mask is not None else dots


def _support_set_mask(p, mask, d, tol):
    """All vertices within `tol` of the support max (AddAllSupports, ref :509-529)."""
    dots = _masked_dots(p, mask, d)
    return dots > jnp.max(dots) - tol, dots


def _permute_rows(p, order):
    """p[order] as a one-hot contraction (N is small; see ROADMAP for
    measuring a gather instead)."""
    onehot = (order[:, None] == jnp.arange(p.shape[0])[None, :]).astype(p.dtype)
    return onehot @ p


def _compact(p, set_mask):
    """Front-compact the masked rows, preserving vertex order (list append order)."""
    # stable compaction: members first in index order (counting, no sort)
    order = counting_argsort((~set_mask).astype(jnp.int32))
    return _permute_rows(p, order), jnp.sum(set_mask)


def nearest_points(p1, p2, normal, mask1=None, mask2=None):
    """Single support vertex of p1 along +normal / p2 along -normal (ref :813-855)."""
    i1 = jnp.argmax(_masked_dots(p1, mask1, normal))
    i2 = jnp.argmax(_masked_dots(p2, mask2, -normal))
    return jnp.stack([p1[i1], p2[i2]])


def collision_type(p1, p2, normal, tol_ff, mask1=None, mask2=None):
    """1 = point-ish contact, 2 = face-face iff both support sets have >= 3
    vertices within TOL_FF of the support max (ref :353-413)."""
    m1, _ = _support_set_mask(p1, mask1, normal, tol_ff)
    m2, _ = _support_set_mask(p2, mask2, -normal, tol_ff)
    c = jnp.sum(m1)
    d = jnp.sum(m2)
    return jnp.where((c >= 3) & (d >= 3), jnp.int32(2), jnp.int32(1))


def _sloppy_top2_scan(p, mask, d, eps):
    """The reference's stateful top-2 scan (ref :722-747): visiting vertices
    in index order, any dot within 1e-8 of (or above) the *current* running
    max shifts the index pair.  Returns (i1, i2) with the ref's 0-fix."""
    n = p.shape[0]
    dots = _masked_dots(p, mask, d)

    def step(i, c):
        max_dot, i1, i2 = c
        upd = dots[i] > max_dot - eps
        if mask is not None:
            upd = upd & mask[i]
        return (
            jnp.where(upd, dots[i], max_dot),
            jnp.where(upd, i, i1),
            jnp.where(upd, i1, i2),
        )

    neg_inf = jnp.asarray(-jnp.inf, p.dtype)
    _, i1, i2 = lax.fori_loop(0, n, step, (neg_inf, jnp.int32(-1), jnp.int32(-1)))
    i2 = jnp.where(i2 < 0, i1, i2)  # "found the max on the first hit" fix (:732)
    return i1, i2


def collision_point_v1(p1, p2, normal, cfg: GJKEPAConfig, mask1=None, mask2=None):
    """Version 1 "experimental" (ref :700-806)."""
    eps = cfg.eps_coincide
    a1, a2 = _sloppy_top2_scan(p1, mask1, normal, eps)
    b1, b2 = _sloppy_top2_scan(p2, mask2, -normal, eps)
    single1 = a1 == a2
    single2 = b1 == b2

    case1 = (p1[a1] + p2[b1]) * 0.5                      # both single: midpoint
    case2 = jnp.where(single1, p1[a1], p2[b1])           # exactly one single: that vertex

    # both multi: mean of p1 vertices within 0.1 of the true max (:766-804)
    set1, dots1 = _support_set_mask(p1, mask1, normal, cfg.support_set_tol)
    cnt = jnp.maximum(jnp.sum(set1), 1).astype(p1.dtype)
    case3 = jnp.sum(jnp.where(set1[:, None], p1, 0.0), axis=0) / cnt

    res = jnp.where(single1 & single2, case1,
                    jnp.where(single1 ^ single2, case2, case3))
    return res


def collision_point_v2(p1, p2, normal, cfg: GJKEPAConfig, mask1=None, mask2=None):
    """Version 2 "general": full (n1, n2) support-set case analysis (ref :457-696)."""
    tol = cfg.support_set_tol  # 1e-1 at the call sites (:471-472)
    set1, _ = _support_set_mask(p1, mask1, normal, tol)
    set2, _ = _support_set_mask(p2, mask2, -normal, tol)
    s1, n1 = _compact(p1, set1)
    s2, n2 = _compact(p2, set2)
    return collision_point_v2_sets(s1, n1, s2, n2, cfg)


def collision_point_v2_sets(s1, n1, s2, n2, cfg: GJKEPAConfig):
    """The version-2 (n1, n2) case dispatch (ref :477-502) over
    front-compacted support sets: s1/s2 are (K, 3) buffers whose first
    n1/n2 rows are the support-set members in collection order (the
    reference's List append order).  Factored out so analytic shapes can
    feed their closed-form candidate sets (ops.manifold's support-polygon
    enumeration) through the exact same case tree."""
    fdt = s1.dtype

    def centroid(s, n):
        k = jnp.arange(s.shape[0]) < n
        return jnp.sum(jnp.where(k[:, None], s, 0.0), axis=0) / jnp.maximum(n, 1).astype(fdt)

    # case_01: vertex-vertex -> midpoint (:531-541)
    c01 = (s1[0] + s2[0]) * 0.5
    # case_02: vertex-face -> the lone vertex (:543-552); caller picks side
    c02_p1, c02_p2 = s1[0], s2[0]
    # case_03: edge-edge -> midpoint of the line-line feet (:554-572)
    feet = foot_ll(s1[:2], s2[:2], cfg.eps_zero)
    c03 = (feet[0] + feet[1]) * 0.5

    # case_04: edge-face (:575-669).  poly = the >=3 set, edge = the 2 set.
    def case_04(poly, n_poly, edge):
        order = sort_clock_indices(poly, n_poly)
        poly_sorted = _permute_rows(poly, order)
        inside0 = is_inside_pf(poly_sorted, edge[0], n_poly, cfg.eps_zero)
        inside1 = is_inside_pf(poly_sorted, edge[1], n_poly, cfg.eps_zero)
        cnt_in = inside0.astype(jnp.int32) + inside1.astype(jnp.int32)
        cent = centroid(poly, n_poly)
        out_foot = foot_pl(cent, edge, cfg.eps_zero)   # case_04_1 (:642-653)
        mid = (edge[0] + edge[1]) * 0.5                # case_04_2/3 (:655-669)
        return jnp.where(cnt_in == 0, out_foot, mid)

    c04_p1poly = case_04(s1, n1, s2[:2])  # n1>=3, n2==2
    c04_p2poly = case_04(s2, n2, s1[:2])  # n1==2, n2>=3
    # case_05: face-face -> centroid of p1's support set (:672-694)
    c05 = centroid(s1, n1)

    res = jnp.where(
        (n1 == 1) & (n2 == 1), c01,
        jnp.where(
            (n1 == 1) & (n2 >= 2), c02_p1,
            jnp.where(
                (n1 >= 2) & (n2 == 1), c02_p2,
                jnp.where(
                    (n1 == 2) & (n2 == 2), c03,
                    jnp.where(
                        (n1 == 2) & (n2 >= 3), c04_p2poly,
                        jnp.where((n1 >= 3) & (n2 == 2), c04_p1poly, c05),
                    ),
                ),
            ),
        ),
    )
    return res


def collision_point_v3(p1, p2, normal, cfg: GJKEPAConfig, mask1=None, mask2=None):
    """Version 3 "stator-rotor special" (ref :426-452): contact point is p2's
    support vertex along -normal with z replaced by p1's mean z; ALSO
    rewrites the normal to its XY-plane projection, renormalized."""
    n = p2.shape[0]
    dots = _masked_dots(p2, mask2, -normal)

    def step(i, c):
        max_dot, idx = c
        upd = dots[i] > max_dot - cfg.eps_coincide
        return jnp.where(upd, dots[i], max_dot), jnp.where(upd, i, idx)

    _, idx = lax.fori_loop(0, n, step, (jnp.asarray(-jnp.inf, p2.dtype), jnp.int32(0)))
    point = p2[idx]
    if mask1 is not None:
        zmean = jnp.sum(jnp.where(mask1, p1[:, 2], 0.0)) / jnp.maximum(jnp.sum(mask1), 1)
    else:
        zmean = jnp.mean(p1[:, 2])
    point = point.at[2].set(zmean.astype(p1.dtype))

    new_normal = normal.at[2].set(0.0)
    nrm = jnp.linalg.norm(new_normal)
    new_normal = new_normal / jnp.where(nrm > 0.0, nrm, 1.0)
    return point, new_normal
