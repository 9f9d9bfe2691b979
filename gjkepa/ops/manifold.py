"""Contact manifolds at the public query surface (bench config c4).

The reference emits exactly ONE contact point per query
(``/root/reference/src/GCLIB_GJKEPA.f90:329-340``); a single point cannot
stabilize stacked face contacts.  This module computes manifolds as a
public op for BOTH hull pairs and analytic shape pairs:

  1. extract each body's *support polygon* along the contact normal
     (the vertices within ``tol`` of the support maximum — the same
     clustering rule the reference's contact-point case tree uses,
     ref :471-529, applied along +n for A and -n for B; analytic shapes
     enumerate closed-form candidate sets: box corners, capsule ends,
     cylinder rim samples);
  2. pick the REFERENCE side (more support vertices = flatter face),
     project both polygons into the contact tangent plane;
  3. clip the incident polygon against the reference polygon
     (masked fixed-capacity Sutherland-Hodgman — a fixed-shape
     re-derivation of polygon clipping: every emit slot is located by
     prefix-sum rank, no dynamic shapes);
  4. per clipped point, per-point penetration depth = signed gap between
     the point's incident-side height and the reference plane along n;
  5. reduce to at most 4 points (deepest, farthest, then two max-area
     picks — the standard manifold reduction) with a validity mask.

Vertex/edge contacts (reference side has < 3 support vertices) fall back
to the single contact point, depth = the query depth — exactly the
reference's output.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GJKEPAConfig
from ..precision import highest_precision

__all__ = ["ManifoldResult", "manifold_batch", "manifold_shapes_batch"]

_CLIP_CAP = 16      # Sutherland-Hodgman working capacity (<= 8 + 8 verts)
_POLY_CAP = 8       # support-polygon capacity per side


class ManifoldResult(NamedTuple):
    points: jnp.ndarray   # (B, 4, 3) contact points (world)
    depths: jnp.ndarray   # (B, 4)    per-point penetration depths (>= 0)
    mask: jnp.ndarray     # (B, 4)    validity
    # (B,) True where a support polygon had MORE vertices within tol than
    # `poly_cap` slots (the polygon was truncated in slot-rank order, so
    # the clipped manifold may under-cover the true contact region —
    # re-run those pairs with a larger poly_cap).  The reference's support
    # sets are unbounded lists (ref :509-529); a fixed-capacity device
    # program must surface the cap instead of truncating silently.
    overflow: jnp.ndarray


def _first_k(sel, pts, k):
    """Compact the selected rows of pts (N,3) into k slots (rank order).

    Gather-free: slot k's source is the unique row with sel & cum==k+1,
    extracted by a one-hot sum.  Every index select in this module is a
    one-hot contraction (exact under HIGHEST precision); whether per-pair
    gathers are faster on the GPU is open (ROADMAP queue 3).

    Returns (points (k, 3), valid (k,), overflow bool — more than k rows
    selected)."""
    cum = jnp.cumsum(sel.astype(jnp.int32))
    n_sel = cum[-1]
    out = []
    for slot in range(k):
        oh = sel & (cum == slot + 1)
        out.append(jnp.sum(jnp.where(oh[:, None], pts, 0.0), axis=0))
    valid = jnp.arange(k) < n_sel
    return jnp.stack(out), valid, n_sel > k


def _hull_support_polygon(p, mask, n, tol, k=_POLY_CAP):
    """Vertices of hull p (N,3) within tol of the support max along n."""
    dots = p @ n
    if mask is not None:
        dots = jnp.where(mask, dots, -jnp.inf)
    m = jnp.max(dots)
    sel = dots >= m - tol
    if mask is not None:
        sel = sel & mask
    return _first_k(sel, p, k)


def _shape_support_polygon(kind, params, pos, rot, n, tol, k=_POLY_CAP):
    """Closed-form support-polygon candidates of one analytic shape along
    world direction n: enumerate a fixed candidate set per kind, keep the
    candidates within tol of the support maximum."""
    from ..models.shapes import BOX, CAPSULE, CYLINDER, SPHERE

    dl = rot.T @ n
    r0, p1 = params[0], params[1]

    # candidate local points, fixed count 18 (padded per kind)
    cands = []
    # sphere support point (also generic fallback for every kind)
    nl = dl / jnp.maximum(jnp.linalg.norm(dl), 1e-20)
    cands.append(r0 * nl)                                  # sphere
    # box corners (8)
    signs = jnp.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                       for sz in (-1, 1)], dl.dtype)
    for i in range(8):
        cands.append(signs[i] * params[:3])
    # capsule ends (2): r*unit(dl) +- (0,0,H)
    zax = jnp.array([0.0, 0.0, 1.0], dl.dtype)
    cands.append(r0 * nl + p1 * zax)
    cands.append(r0 * nl - p1 * zax)
    # cylinder rim samples: 8 grid angles on the supported cap + the exact
    # lateral rim angle on both caps (8 + 2, reuses the capsule slots' count)
    rho = jnp.sqrt(dl[0] ** 2 + dl[1] ** 2)
    co = jnp.where(rho > 1e-12, dl[0] / jnp.maximum(rho, 1e-20), 1.0)
    si = jnp.where(rho > 1e-12, dl[1] / jnp.maximum(rho, 1e-20), 0.0)
    sz_ = jnp.where(dl[2] >= 0, 1.0, -1.0)
    import numpy as _np
    for a in _np.linspace(0.0, 2 * _np.pi, 8, endpoint=False):
        cands.append(jnp.array([r0 * _np.cos(a), r0 * _np.sin(a), 0.0],
                               dl.dtype) + sz_ * p1 * zax)
    cands.append(jnp.stack([r0 * co, r0 * si, p1]))
    cands.append(jnp.stack([r0 * co, r0 * si, -p1]))
    local = jnp.stack(cands)                                # (20, 3)

    n_c = local.shape[0]
    is_sph = kind == SPHERE
    is_box = kind == BOX
    is_cap = kind == CAPSULE
    is_cyl = kind == CYLINDER
    idx = jnp.arange(n_c)
    kind_ok = jnp.where(is_sph, idx == 0,
                        jnp.where(is_box, (idx >= 1) & (idx <= 8),
                                  jnp.where(is_cap, (idx >= 9) & (idx <= 10),
                                            idx >= 11)))
    dots = local @ dl
    m = jnp.max(jnp.where(kind_ok, dots, -jnp.inf))
    sel = kind_ok & (dots >= m - tol)
    pts, valid, over = _first_k(sel, local, k)
    world = pts @ rot.T + pos
    del is_cyl
    return world, valid, over


def _ccw_sort_apply(p2, valid, *extras):
    """Reorder the valid 2-D points CCW around their centroid (invalid
    slots last), applying the same permutation to `extras` — gather-free:
    per-element rank by pairwise angle compares, then a (K, K) one-hot
    contraction places each element (K <= 8)."""
    k = p2.shape[0]
    cnt = jnp.maximum(jnp.sum(valid), 1)
    c = jnp.sum(jnp.where(valid[:, None], p2, 0.0), axis=0) / cnt
    ang = jnp.arctan2(p2[:, 1] - c[1], p2[:, 0] - c[0])
    big = jnp.float32(3.0e38)
    ang = jnp.where(valid, ang, big)            # invalid slots sort last
    iota = jnp.arange(k)
    less = (ang[None, :] < ang[:, None]) | (
        (ang[None, :] == ang[:, None]) & (iota[None, :] < iota[:, None]))
    rank = jnp.sum(less.astype(jnp.int32), axis=1)          # (K,)
    oh = (rank[:, None] == iota[None, :]).astype(p2.dtype)  # src -> dest
    out_p2 = jnp.einsum("sd,sx->dx", oh, p2)
    out_valid = jnp.einsum("sd,s->d", oh, valid.astype(p2.dtype)) > 0.5
    outs = []
    for e in extras:
        if e.ndim == 1:
            outs.append(jnp.einsum("sd,s->d", oh, e))
        else:
            outs.append(jnp.einsum("sd,sx->dx", oh, e))
    return (out_p2, out_valid, *outs)


def _clip_polygon(ref2, ref_valid, inc2, inc_z, inc_valid, cap=_CLIP_CAP):
    """Masked Sutherland-Hodgman: clip (inc2, inc_z) by convex CCW ref2.

    Returns (pts2 (cap,2), z (cap,), valid); cap must be >= |inc| + |ref|
    (a convex clip adds at most one vertex per clipping edge).  z
    interpolates linearly at edge crossings (it is an affine field over
    the incident polygon's plane)."""
    n_ref = jnp.sum(ref_valid.astype(jnp.int32))

    pts = jnp.zeros((cap, 2), inc2.dtype).at[:inc2.shape[0]].set(inc2)
    z = jnp.zeros((cap,), inc_z.dtype).at[:inc_z.shape[0]].set(inc_z)
    valid = jnp.zeros((cap,), bool).at[:inc_valid.shape[0]].set(inc_valid)

    ref_iota = jnp.arange(ref2.shape[0])

    def clip_edge(carry, e):  # e: traced int32 scalar
        pts, z, valid = carry
        cnt = jnp.sum(valid.astype(jnp.int32))
        # edge endpoints by one-hot sums (see _first_k)
        oh_a = (ref_iota == jnp.minimum(e, n_ref - 1)).astype(ref2.dtype)
        oh_b = (ref_iota == jnp.where(e + 1 >= n_ref, 0, e + 1)).astype(ref2.dtype)
        a = oh_a @ ref2
        b = oh_b @ ref2
        edge_on = e < n_ref
        eab = b - a

        def inside(p):
            return eab[0] * (p[:, 1] - a[1]) - eab[1] * (p[:, 0] - a[0]) >= 0.0

        iota_c = jnp.arange(cap)
        p_cur, z_cur = pts, z
        # next-in-polygon: roll by one, wrapping slot cnt-1 back to slot 0
        wrap = (iota_c == cnt - 1)
        p_nxt = jnp.where(wrap[:, None], pts[0:1], jnp.roll(pts, -1, axis=0))
        z_nxt = jnp.where(wrap, z[0], jnp.roll(z, -1))
        in_cur = inside(p_cur)
        in_nxt = inside(p_nxt)
        live = jnp.arange(cap) < cnt
        # intersection of segment (cur -> nxt) with the edge line
        d_cur = eab[0] * (p_cur[:, 1] - a[1]) - eab[1] * (p_cur[:, 0] - a[0])
        d_nxt = eab[0] * (p_nxt[:, 1] - a[1]) - eab[1] * (p_nxt[:, 0] - a[0])
        den = d_cur - d_nxt
        t = d_cur / jnp.where(jnp.abs(den) > 1e-20, den, 1e-20)
        t = jnp.clip(t, 0.0, 1.0)
        p_x = p_cur + t[:, None] * (p_nxt - p_cur)
        z_x = z_cur + t * (z_nxt - z_cur)

        emit_self = live & in_cur
        emit_cross = live & (in_cur ^ in_nxt)
        contrib = emit_self.astype(jnp.int32) + emit_cross.astype(jnp.int32)
        cum = jnp.cumsum(contrib)
        base = cum - contrib                    # first slot of entry i
        out_cnt = cum[-1]
        slot_self = base
        slot_cross = base + emit_self.astype(jnp.int32)
        iota = jnp.arange(cap)
        new_p = jnp.zeros_like(pts)
        new_z = jnp.zeros_like(z)
        for src in range(cap):
            sm = emit_self[src] & (iota == slot_self[src])
            new_p = jnp.where(sm[:, None], p_cur[src], new_p)
            new_z = jnp.where(sm, z_cur[src], new_z)
            xm = emit_cross[src] & (iota == slot_cross[src])
            new_p = jnp.where(xm[:, None], p_x[src], new_p)
            new_z = jnp.where(xm, z_x[src], new_z)
        new_valid = iota < out_cnt
        pts = jnp.where(edge_on, new_p, pts)
        z = jnp.where(edge_on, new_z, z)
        valid = jnp.where(edge_on, new_valid, valid)
        return (pts, z, valid), None

    # lax.scan over the reference edges keeps one copy of the per-edge pass
    # in the program instead of a static unroll
    (pts, z, valid), _ = jax.lax.scan(clip_edge, (pts, z, valid),
                                      jnp.arange(ref2.shape[0]))
    return pts, z, valid


def _reduce4(p2, depths, valid):
    """Standard 4-point manifold reduction: deepest, farthest, 2x max-area.

    Returns a (4, K) one-hot selection matrix (matmul-extractable — no
    dynamic gathers, see _first_k) + the kept mask."""
    big_neg = -jnp.inf
    kk = p2.shape[0]
    score0 = jnp.where(valid, depths, big_neg)
    k0 = jnp.argmax(score0)
    oh0 = jax.nn.one_hot(k0, kk, dtype=p2.dtype)
    pt0 = oh0 @ p2
    taken = oh0 > 0.5

    d1 = jnp.linalg.norm(p2 - pt0, axis=1)
    k1 = jnp.argmax(jnp.where(valid & ~taken, d1, big_neg))
    oh1 = jax.nn.one_hot(k1, kk, dtype=p2.dtype)
    pt1 = oh1 @ p2
    taken = taken | (oh1 > 0.5)

    e01 = pt1 - pt0
    v = p2 - pt0
    ar = e01[0] * v[:, 1] - e01[1] * v[:, 0]
    k2 = jnp.argmax(jnp.where(valid & ~taken, ar, big_neg))
    oh2 = jax.nn.one_hot(k2, kk, dtype=p2.dtype)
    taken = taken | (oh2 > 0.5)
    k3 = jnp.argmax(jnp.where(valid & ~taken, -ar, big_neg))
    oh3 = jax.nn.one_hot(k3, kk, dtype=p2.dtype)

    n_valid = jnp.sum(valid.astype(jnp.int32))
    sel = jnp.stack([oh0, oh1, oh2, oh3])                  # (4, K)
    keep = jnp.arange(4) < jnp.minimum(n_valid, 4)
    return sel, keep


def _manifold_one(pa, va, pb, vb, n, depth, fallback_pt, tol_inside,
                  clip_cap=_CLIP_CAP):
    """Manifold of one pair from support polygons pa/pb (world, masked)."""
    dtype = pa.dtype
    # tangent frame
    helper = jnp.where(jnp.abs(n[0]) < 0.9,
                       jnp.array([1.0, 0.0, 0.0], dtype),
                       jnp.array([0.0, 1.0, 0.0], dtype))
    u = jnp.cross(n, helper)
    u = u / jnp.maximum(jnp.linalg.norm(u), 1e-20)
    v = jnp.cross(n, u)

    def project(p):
        return jnp.stack([p @ u, p @ v], axis=1), p @ n

    a2, az = project(pa)
    b2, bz = project(pb)
    n_a = jnp.sum(va.astype(jnp.int32))
    n_b = jnp.sum(vb.astype(jnp.int32))
    ref_is_a = n_a >= n_b

    ref2 = jnp.where(ref_is_a, a2, b2)
    refv = jnp.where(ref_is_a, va, vb)
    inc2 = jnp.where(ref_is_a, b2, a2)
    incz = jnp.where(ref_is_a, bz, az)
    incv = jnp.where(ref_is_a, vb, va)
    # reference plane height along n: A's max (face at support max) or B's min
    ref_z = jnp.where(ref_is_a,
                      jnp.max(jnp.where(va, az, -jnp.inf)),
                      jnp.min(jnp.where(vb, bz, jnp.inf)))

    ref2s, refvs = _ccw_sort_apply(ref2, refv)
    inc2s, incvs, inczs = _ccw_sort_apply(inc2, incv, incz)
    cp2, cz, cvalid = _clip_polygon(ref2s, refvs, inc2s, inczs, incvs,
                                    cap=clip_cap)

    # per-point depth: incident height vs reference plane along n
    pdepth = jnp.where(ref_is_a, ref_z - cz, cz - ref_z)
    cvalid = cvalid & (pdepth > -tol_inside)
    pdepth = jnp.maximum(pdepth, 0.0)

    sel, keep = _reduce4(cp2, pdepth, cvalid)
    pts2 = sel @ cp2                                       # (4, 2)
    zs = sel @ cz
    points = pts2[:, 0:1] * u[None, :] + pts2[:, 1:2] * v[None, :] \
        + zs[:, None] * n[None, :]
    depths = sel @ pdepth

    # fallbacks: reference not a face (< 3 verts) or clip emptied out
    degenerate = (jnp.maximum(n_a, n_b) < 3) | ~jnp.any(cvalid)
    pt0 = jnp.where(degenerate, fallback_pt, points[0])
    points = points.at[0].set(pt0)
    depths = depths.at[0].set(jnp.where(degenerate, depth, depths[0]))
    keep = jnp.where(degenerate,
                     jnp.arange(4) == 0, keep)
    return points, depths, keep


@highest_precision
def manifold_batch(p1, p2, normal, depth, hit, contact_point,
                   mask1=None, mask2=None,
                   cfg: GJKEPAConfig | None = None,
                   tol: float | None = None,
                   poly_cap: int = _POLY_CAP) -> ManifoldResult:
    """Up-to-4-point contact manifolds for hull pairs.

    Args:
      p1, p2: (B, N, 3) padded vertex buffers.
      normal, depth, hit, contact_point: outputs of a narrow-phase query
        (``gjkepa_batch``) — normal points A -> B.
      tol: support-set clustering tolerance (default:
        ``cfg.support_set_tol``, the reference's 0.1 rule, ref :471-529).
      poly_cap: support-polygon capacity per side (cost scales ~cap^2;
        pass 4 when faces are known quads, e.g. boxes).
    """
    cfg = cfg or GJKEPAConfig.for_f32()
    tol = cfg.support_set_tol if tol is None else tol

    def one(pa, pb, ma, mb, n, d, h, cpt):
        sa, va, ova = _hull_support_polygon(pa, ma, n, tol, k=poly_cap)
        sb, vb, ovb = _hull_support_polygon(pb, mb, -n, tol, k=poly_cap)
        pts, dps, keep = _manifold_one(sa, va, sb, vb, n, d, cpt,
                                       tol_inside=tol,
                                       clip_cap=2 * poly_cap)
        keep = keep & h
        return pts, dps, keep, (ova | ovb) & h

    in_axes = (0, 0, None if mask1 is None else 0,
               None if mask2 is None else 0, 0, 0, 0, 0)
    pts, dps, keep, over = jax.vmap(one, in_axes=in_axes)(
        p1, p2, mask1, mask2, normal, depth, hit, contact_point)
    return ManifoldResult(points=pts, depths=dps, mask=keep, overflow=over)


@highest_precision
def manifold_shapes_batch(a, b, normal, depth, hit, contact_point,
                          cfg: GJKEPAConfig | None = None,
                          tol: float | None = None,
                          poly_cap: int = _POLY_CAP) -> ManifoldResult:
    """Up-to-4-point contact manifolds for analytic shape pairs
    (:class:`gjkepa.models.ShapeBatch`).  `poly_cap` as in
    :func:`manifold_batch` (cylinder cap discs want the full 8; box-only
    workloads can pass 4 — 4x less clip work)."""
    cfg = cfg or GJKEPAConfig.for_f32()
    tol = cfg.support_set_tol if tol is None else tol

    def one(ka, pma, xa, ra, kb, pmb, xb, rb, n, d, h, cpt):
        sa, va, ova = _shape_support_polygon(ka, pma, xa, ra, n, tol,
                                             k=poly_cap)
        sb, vb, ovb = _shape_support_polygon(kb, pmb, xb, rb, -n, tol,
                                             k=poly_cap)
        pts, dps, keep = _manifold_one(sa, va, sb, vb, n, d, cpt,
                                       tol_inside=tol,
                                       clip_cap=2 * poly_cap)
        keep = keep & h
        return pts, dps, keep, (ova | ovb) & h

    pts, dps, keep, over = jax.vmap(one)(
        a.kind, a.params, a.pos, a.rot, b.kind, b.params, b.pos, b.rot,
        normal, depth, hit, contact_point)
    return ManifoldResult(points=pts, depths=dps, mask=keep, overflow=over)


@highest_precision
def manifold_hull_shape_batch(p1, shapes, normal, depth, hit,
                              contact_point=None, mask1=None,
                              cfg: GJKEPAConfig | None = None,
                              tol: float | None = None,
                              poly_cap: int = _POLY_CAP) -> ManifoldResult:
    """Up-to-4-point contact manifolds for mixed hull-vs-shape pairs:
    side A a (B, N, 3) padded vertex buffer, side B a
    :class:`gjkepa.models.ShapeBatch`.  Feed it the outputs of
    :func:`gjkepa.api.collide_hull_shape_batch` (normal points
    A -> B).  `contact_point` is the degenerate-clip fallback point;
    when omitted it defaults to the centroid of side A's support polygon."""
    cfg = cfg or GJKEPAConfig.for_f32()
    tol = cfg.support_set_tol if tol is None else tol

    def one(pa, ma, kb, pmb, xb, rb, n, d, h, cpt):
        sa, va, ova = _hull_support_polygon(pa, ma, n, tol, k=poly_cap)
        sb, vb, ovb = _shape_support_polygon(kb, pmb, xb, rb, -n, tol,
                                             k=poly_cap)
        if cpt is None:
            cpt = (jnp.sum(jnp.where(va[:, None], sa, 0.0), axis=0)
                   / jnp.maximum(jnp.sum(va), 1))
        pts, dps, keep = _manifold_one(sa, va, sb, vb, n, d, cpt,
                                       tol_inside=tol,
                                       clip_cap=2 * poly_cap)
        keep = keep & h
        return pts, dps, keep, (ova | ovb) & h

    in_axes = (0, None if mask1 is None else 0, 0, 0, 0, 0, 0, 0, 0,
               None if contact_point is None else 0)
    pts, dps, keep, over = jax.vmap(one, in_axes=in_axes)(
        p1, mask1, shapes.kind, shapes.params, shapes.pos, shapes.rot,
        normal, depth, hit, contact_point)
    return ManifoldResult(points=pts, depths=dps, mask=keep, overflow=over)
