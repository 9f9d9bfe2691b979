"""Contact derivation for analytic shape pairs (ref :329-343 on shapes).

The reference always emits nearest points, contact point and contact type
after EPA (``/root/reference/src/GCLIB_GJKEPA.f90:326-343``); its case
trees walk the hulls' vertex arrays.  Analytic shapes have no vertex
arrays, so the support SETS feeding those case trees are produced by the
closed-form candidate enumeration of :mod:`gjkepa.ops.manifold`
(`_shape_support_polygon`: box corners, capsule segment ends, cylinder cap
rim samples, sphere point) and fed through the exact same version-2
(n1, n2) dispatch (:func:`gjkepa.ops.contact.collision_point_v2_sets`).

Version semantics on shapes (documented deviations — the reference's
versions are defined on vertex clouds only, ref :43-46):

  * version 2 (the "general" path, ref :457-696): exact case-tree parity,
    with candidate enumeration order standing in for vertex index order.
  * version 1 (ref :700-806): single/multi classification from the
    candidate-set sizes instead of the sloppy top-2 index scan (no vertex
    indices exist to scan); the three outcomes (midpoint / lone vertex /
    mean of A's set) are preserved.
  * version 3 (ref :426-452): B's support point along -normal with z
    replaced by A's mean z -> A's center z for a shape; the XY normal
    rewrite is applied verbatim.

Contact type (ref :353-413): both candidate sets within TOL_FF of the
support max must have >= 3 members -> type 2 (face-face), else 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import GJKEPAConfig
from .contact import collision_point_v2_sets
from .manifold import _shape_support_polygon

__all__ = ["derive_contact_shapes_batch"]

_K = 8  # candidate-set capacity (box face = 4, cylinder cap rim = 8)


def _support_first(kind, params, pos, rot, d):
    """Support point with the CLOUD tie-break: the reference's
    get_nearest_points takes the first vertex achieving the max in vertex
    order (ref :813-855, strict-> scan).  For a box whose corners are
    enumerated (-,-,-),(-,-,+),... (the candidate-table order), the first
    maximizer picks -h on every zero direction component — mirrored here
    with a strict > test so box faces return the same corner as their
    corner-cloud twin.  Curved kinds have a.e.-unique maximizers."""
    from ..models.shapes import BOX, shape_support_world

    w = shape_support_world(kind, params, pos, rot, d)
    dl = rot.T @ d
    wbox = rot @ jnp.where(dl > 0.0, params[:3], -params[:3]) + pos
    return jnp.where(kind == BOX, wbox, w)


def _one_pair(ka, pa, xa, ra, kb, pb, xb, rb, normal, cfg: GJKEPAConfig):
    # nearest points: single support along +/-normal (ref :813-855)
    wa = _support_first(ka, pa, xa, ra, normal)
    wb = _support_first(kb, pb, xb, rb, -normal)
    npts = jnp.stack([wa, wb])

    # support sets at the 0.1 clustering tolerance (ref :471-472)
    sa, va, _ = _shape_support_polygon(ka, pa, xa, ra, normal,
                                       cfg.support_set_tol, k=_K)
    sb, vb, _ = _shape_support_polygon(kb, pb, xb, rb, -normal,
                                       cfg.support_set_tol, k=_K)
    n1 = jnp.sum(va.astype(jnp.int32))
    n2 = jnp.sum(vb.astype(jnp.int32))

    if cfg.version == 2:
        cpoint = collision_point_v2_sets(sa, n1, sb, n2, cfg)
        out_normal = normal
    elif cfg.version == 1:
        # both single -> midpoint; exactly one single -> that point;
        # both multi -> mean of A's support set (ref :754-804)
        single1 = n1 == 1
        single2 = n2 == 1
        case1 = 0.5 * (sa[0] + sb[0])
        case2 = jnp.where(single1, sa[0], sb[0])
        cnt = jnp.maximum(n1, 1).astype(sa.dtype)
        case3 = jnp.sum(jnp.where(va[:, None], sa, 0.0), axis=0) / cnt
        cpoint = jnp.where(single1 & single2, case1,
                           jnp.where(single1 ^ single2, case2, case3))
        out_normal = normal
    elif cfg.version == 3:
        # B's support along -normal, z := A's center z; normal -> XY
        # (:426-452).  The reference's sloppy scan (:434-441, running max
        # may drop within eps) lands on the LAST vertex within eps of the
        # max — on a box-face tie that is the +h corner on every zero
        # direction component, i.e. shape_support_world's >= rule, NOT the
        # nearest-points first-index rule.
        from ..models.shapes import shape_support_world

        wb_last = shape_support_world(kb, pb, xb, rb, -normal)
        cpoint = wb_last.at[2].set(xa[2])
        nn = normal.at[2].set(0.0)
        nrm = jnp.linalg.norm(nn)
        out_normal = nn / jnp.where(nrm > 0.0, nrm, 1.0)
    else:
        raise ValueError(f"unknown contact-point version {cfg.version!r} "
                         "(reference supports 1, 2, 3; ref :329-340)")

    # contact type at TOL_FF (ref :353-413), counted on the rewritten
    # normal like the reference (:343 runs after the version dispatch)
    _, ta, _ = _shape_support_polygon(ka, pa, xa, ra, out_normal,
                                      cfg.face_contact_tol, k=_K)
    _, tb, _ = _shape_support_polygon(kb, pb, xb, rb, -out_normal,
                                      cfg.face_contact_tol, k=_K)
    c = jnp.sum(ta.astype(jnp.int32))
    d = jnp.sum(tb.astype(jnp.int32))
    ctype = jnp.where((c >= 3) & (d >= 3), jnp.int32(2), jnp.int32(1))
    return npts, cpoint, out_normal, ctype


def derive_contact_shapes_batch(a, b, normal, cfg: GJKEPAConfig):
    """Batched contact derivation for analytic shape pairs.

    Args:
      a, b: :class:`gjkepa.models.ShapeBatch` (length B).
      normal: (B, 3) EPA/closed-form contact normals (A -> B).

    Returns (nearest_points (B,2,3), contact_point (B,3), normal (B,3),
    colli_type (B,)) — the full ref :47-52 contact surface; only
    meaningful on hit lanes (callers zero miss lanes, ref :65-71).
    """
    def one(ka, pa, xa, ra, kb, pb, xb, rb, n):
        return _one_pair(ka, pa, xa, ra, kb, pb, xb, rb, n, cfg)

    return jax.vmap(one)(a.kind, a.params, a.pos, a.rot,
                         b.kind, b.params, b.pos, b.rot, normal)
