"""Exact narrow-phase answers for the analytic pair types that have them.

The reference handles vertex clouds only; for analytic shapes, polytope
EPA converges slowest on smooth surfaces and still carries ~1e-4*R
polyhedral depth error there.  For these pair types the penetration depth
and normal have closed forms that are exact to the working precision:

  * {sphere, capsule} x {sphere, capsule}: swept-sphere segment-segment
    closest points;
  * sphere-box (either order): point-box clamp, exit through the nearest
    face when the center is inside;
  * sphere-cylinder (either order): point vs solid cylinder;
  * box-box: separating-axis minimum translation over the 15 axes (the face
    normals of the box-box Minkowski difference).

:func:`gjkepa.api.collide_shapes_batch` overrides its GJK/EPA answer
with these on every lane they handle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import Status

__all__ = ["closed_form_shape_pairs"]


def closed_form_shape_pairs(a, b, broadphase_tol):
    """Closed-form answers over a batch of analytic shape pairs.

    Args:
      a, b: :class:`gjkepa.models.ShapeBatch` of equal length B.
      broadphase_tol: gap beyond which a miss reports MISS_BROADPHASE.

    Returns (handled, hit, depth, normal (B,3), distance, status); fields
    are only meaningful where `handled`.  The normal points A -> B
    (translating B by depth*normal separates the pair), matching the EPA
    convention.
    """
    from ..models.shapes import BOX, CAPSULE, CYLINDER, SPHERE

    dtype = a.params.dtype
    k1, k2 = a.kind, b.kind
    r1, r2 = a.params[:, 0], b.params[:, 0]
    is_ss1 = (k1 == SPHERE) | (k1 == CAPSULE)
    is_ss2 = (k2 == SPHERE) | (k2 == CAPSULE)
    both_swept = is_ss1 & is_ss2
    sb = (k1 == SPHERE) & (k2 == BOX)
    bs = (k1 == BOX) & (k2 == SPHERE)
    sc = (k1 == SPHERE) & (k2 == CYLINDER)
    cs = (k1 == CYLINDER) & (k2 == SPHERE)
    bbx = (k1 == BOX) & (k2 == BOX)
    handled = both_swept | sb | bs | sc | cs | bbx

    # -- swept-sphere pair: segment-segment closest points -------------------
    L1 = jnp.where(k1 == CAPSULE, a.params[:, 1], 0.0)
    L2 = jnp.where(k2 == CAPSULE, b.params[:, 1], 0.0)
    u1 = a.rot[:, :, 2]                       # capsule axis: local z, world
    u2 = b.rot[:, :, 2]
    rvec = a.pos - b.pos
    bb = jnp.einsum("ij,ij->i", u1, u2)
    cc = jnp.einsum("ij,ij->i", u1, rvec)
    ff = jnp.einsum("ij,ij->i", u2, rvec)
    den = 1.0 - bb * bb
    s0 = jnp.where(den > 1e-12, (ff * bb - cc) / jnp.where(den > 1e-12, den, 1.0),
                   0.0)
    s = jnp.clip(s0, -L1, L1)
    t = jnp.clip(s * bb + ff, -L2, L2)
    s = jnp.clip(t * bb - cc, -L1, L1)
    q1 = a.pos + s[:, None] * u1
    q2 = b.pos + t[:, None] * u2
    dvec = q2 - q1
    dist_core = jnp.linalg.norm(dvec, axis=1)
    safe = jnp.maximum(dist_core, 1e-20)
    n_ss = jnp.where((dist_core > 1e-12)[:, None], dvec / safe[:, None],
                     jnp.array([0.0, 0.0, 1.0], dtype)[None, :])
    depth_ss = r1 + r2 - dist_core
    gap_ss = dist_core - (r1 + r2)

    # -- sphere-box (either order) -------------------------------------------
    def sphere_vs_box(c_sph, r_sph, p_box, rot_box, h_box):
        dl = jnp.einsum("ikj,ik->ij", rot_box, c_sph - p_box)  # R^T (c - p)
        cl = jnp.clip(dl, -h_box, h_box)
        delta = dl - cl
        d_out = jnp.linalg.norm(delta, axis=1)
        outside = d_out > 1e-12
        n_out_l = -delta / jnp.maximum(d_out, 1e-20)[:, None]
        # inside: exit through the nearest face
        pen = h_box - jnp.abs(dl)
        ax = jnp.argmin(pen, axis=1)
        oh = jax.nn.one_hot(ax, 3, dtype=dl.dtype)
        sgn = jnp.sign(jnp.einsum("ij,ij->i", oh, dl))
        sgn = jnp.where(sgn == 0.0, 1.0, sgn)
        n_in_l = -(sgn[:, None] * oh)
        depth = jnp.where(outside, r_sph - d_out,
                          r_sph + jnp.min(pen, axis=1))
        n_l = jnp.where(outside[:, None], n_out_l, n_in_l)
        n_w = jnp.einsum("ijk,ik->ij", rot_box, n_l)       # R n
        return depth, n_w, jnp.maximum(d_out - r_sph, 0.0)

    d_sb, n_sb, gap_sb = sphere_vs_box(a.pos, r1, b.pos, b.rot, b.params)
    d_bs, n_bs, gap_bs = sphere_vs_box(b.pos, r2, a.pos, a.rot, a.params)
    n_bs = -n_bs

    # -- sphere-cylinder (either order): point vs solid cylinder -------------
    def sphere_vs_cyl(c_sph, r_sph, p_cyl, rot_cyl, prm_cyl):
        rc, hc = prm_cyl[:, 0], prm_cyl[:, 1]
        dl = jnp.einsum("ikj,ik->ij", rot_cyl, c_sph - p_cyl)  # R^T (c - p)
        rho = jnp.sqrt(dl[:, 0] ** 2 + dl[:, 1] ** 2)
        inv_rho = 1.0 / jnp.maximum(rho, 1e-20)
        # exactly 1.0 inside, so an interior center projects onto itself
        scale = jnp.where(rho > rc, rc * inv_rho, 1.0)
        q = jnp.stack([dl[:, 0] * scale, dl[:, 1] * scale,
                       jnp.clip(dl[:, 2], -hc, hc)], axis=1)
        delta = dl - q
        d_out = jnp.linalg.norm(delta, axis=1)
        outside = d_out > 1e-12
        n_out = -delta / jnp.maximum(d_out, 1e-20)[:, None]
        pen_lat = rc - rho
        pen_cap = hc - jnp.abs(dl[:, 2])
        use_lat = pen_lat <= pen_cap
        lx = jnp.where(rho > 1e-12, dl[:, 0] * inv_rho, 1.0)
        ly = jnp.where(rho > 1e-12, dl[:, 1] * inv_rho, 0.0)
        sgz = jnp.where(dl[:, 2] >= 0.0, 1.0, -1.0)
        n_in = jnp.stack([jnp.where(use_lat, -lx, 0.0),
                          jnp.where(use_lat, -ly, 0.0),
                          jnp.where(use_lat, 0.0, -sgz)], axis=1)
        depth = jnp.where(outside, r_sph - d_out,
                          r_sph + jnp.minimum(pen_lat, pen_cap))
        n_l = jnp.where(outside[:, None], n_out, n_in)
        n_w = jnp.einsum("ijk,ik->ij", rot_cyl, n_l)
        return depth, n_w, jnp.maximum(d_out - r_sph, 0.0)

    d_sc, n_sc, gap_sc = sphere_vs_cyl(a.pos, r1, b.pos, b.rot, b.params)
    d_cs, n_cs, gap_cs = sphere_vs_cyl(b.pos, r2, a.pos, a.rot, a.params)
    n_cs = -n_cs

    # -- box-box: SAT minimum-translation over the 15 axes -------------------
    def box_box_sat():
        big = jnp.finfo(dtype).max
        t = b.pos - a.pos                              # (B, 3)
        ax = [a.rot[:, :, j] for j in range(3)]        # world axis columns
        bx = [b.rot[:, :, j] for j in range(3)]
        axes = ax + bx + [jnp.cross(ax[i], bx[j])
                          for i in range(3) for j in range(3)]
        nB = t.shape[0]
        best = jnp.full((nB,), big, dtype)
        bn = jnp.zeros((nB, 3), dtype)
        sep = jnp.full((nB,), -big, dtype)
        for L in axes:
            ln2 = jnp.einsum("ij,ij->i", L, L)
            valid = ln2 > 1e-12
            inv = 1.0 / jnp.sqrt(jnp.where(valid, ln2, 1.0))
            s = jnp.einsum("ij,ij->i", t, L) * inv
            ra = sum(a.params[:, i] * jnp.abs(jnp.einsum("ij,ij->i", ax[i], L))
                     for i in range(3)) * inv
            rb = sum(b.params[:, j] * jnp.abs(jnp.einsum("ij,ij->i", bx[j], L))
                     for j in range(3)) * inv
            ov = ra + rb - jnp.abs(s)
            sep = jnp.maximum(sep, jnp.where(valid, -ov, -big))
            ovv = jnp.where(valid, ov, big)
            better = ovv < best
            best = jnp.where(better, ovv, best)
            sgn = jnp.where(s >= 0.0, 1.0, -1.0)
            bn = jnp.where(better[:, None], L * (inv * sgn)[:, None], bn)
        return best, bn, jnp.maximum(sep, 0.0)

    d_bb, n_bb, gap_bb = box_box_sat()

    depth = jnp.where(both_swept, depth_ss, jnp.where(sb, d_sb, d_bs))
    normal = jnp.where(both_swept[:, None], n_ss,
                       jnp.where(sb[:, None], n_sb, n_bs))
    gap = jnp.where(both_swept, gap_ss, jnp.where(sb, gap_sb, gap_bs))
    depth = jnp.where(sc, d_sc, jnp.where(cs, d_cs, depth))
    normal = jnp.where(sc[:, None], n_sc, jnp.where(cs[:, None], n_cs, normal))
    gap = jnp.where(sc, gap_sc, jnp.where(cs, gap_cs, gap))
    depth = jnp.where(bbx, d_bb, depth)
    normal = jnp.where(bbx[:, None], n_bb, normal)
    gap = jnp.where(bbx, gap_bb, gap)
    hit = handled & (depth > 0.0)
    depth = jnp.where(hit, depth, 0.0)
    normal = jnp.where(hit[:, None], normal, 0.0)
    bp_miss = gap > broadphase_tol
    status = jnp.where(hit, jnp.int32(Status.HIT),
                       jnp.where(bp_miss, jnp.int32(Status.MISS_BROADPHASE),
                                 jnp.int32(Status.MISS_GJK)))
    return handled, hit, depth, normal, gap, status
