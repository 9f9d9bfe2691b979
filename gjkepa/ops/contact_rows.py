"""Batch-row (lane-minor) contact derivation.

Same observable semantics as :mod:`gjkepa.ops.contact` (the reference's
contact post-processing, ``/root/reference/src/GCLIB_GJKEPA.f90``:
get_nearest_points :813-855, get_info_collisionType :353-413,
get_collisionPoint_01/02/03 :700/:457/:426) but computed over the whole
batch with the PAIR axis minor.

Why this exists: the vmapped per-pair implementation materializes
(B, N, 3) intermediates with a minor dimension of 3 and lowers tiny
per-lane matmuls and 24-step scalar scans.  Here every per-vertex quantity
is an (N, B) array (B minor) and every per-lane quantity is (B,).  Whether
this layout still pays on the GPU is not measured (ROADMAP queue 3).  The
vmapped path remains as the differential oracle (tests/test_contact_rows).

All reference quirks are preserved exactly: the 0.1 support clustering,
the angular SORT_CLOCK equivalence (point 0 pinned first, input order on
all-coincident), IS_INSIDE_PF's XOY->XOZ fallback with the 1e-12 zero
clamp and first-element sign-flip test, FOOT_LL's parallel fallback, and
version 1/3's sloppy sequential top-2 scans (running max may drop within
eps, visiting vertices in index order).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..config import GJKEPAConfig

__all__ = ["derive_contact_rows"]


def _row_permute(arrs, order):
    """Permute rows of each (N, B) array in `arrs` by the per-lane row
    index array `order` ((N, B): output row i of lane b = input row
    order[i, b]).  One-hot accumulation instead of per-lane row
    gathers."""
    n = order.shape[0]
    outs = [jnp.zeros_like(a) for a in arrs]
    for k in range(n):
        sel = order == k
        outs = [jnp.where(sel, a[k:k + 1, :], o) for a, o in zip(arrs, outs)]
    return outs


def _nth_member(mask, rank, k, arrs):
    """Coordinates of the k-th set member in index order ((B,) each)."""
    sel = mask & (rank == k)
    return [jnp.sum(jnp.where(sel, a, 0.0), axis=0) for a in arrs]


def _utz3(x, y, z, eps):
    n = jnp.sqrt(x * x + y * y + z * z)
    bad = n < eps
    inv = 1.0 / jnp.where(bad, 1.0, n)
    zero = jnp.zeros_like(x)
    return (jnp.where(bad, zero, x * inv), jnp.where(bad, zero, y * inv),
            jnp.where(bad, zero, z * inv))


def _foot_pl(px, py, pz, ax, ay, az, bx, by, bz, eps):
    """Foot of perpendicular from point p to line (a, b) (FOOT_PL)."""
    ux, uy, uz = _utz3(bx - ax, by - ay, bz - az, eps)
    t = (px - ax) * ux + (py - ay) * uy + (pz - az) * uz
    return ax + t * ux, ay + t * uy, az + t * uz


def _foot_ll(p1, q1, p2, q2, eps):
    """Closest points between lines (p1,q1) and (p2,q2) (FOOT_LL,
    ref :1446-1487) — each argument is an (x, y, z) triple of (B,) arrays.
    Returns the two feet as triples."""
    d1 = tuple(b - a for a, b in zip(p1, q1))
    d2 = tuple(b - a for a, b in zip(p2, q2))
    r = tuple(a - b for a, b in zip(p1, p2))
    dot = lambda u, v: u[0] * v[0] + u[1] * v[1] + u[2] * v[2]  # noqa: E731
    a = dot(d1, d1)
    b = dot(d1, d2)
    c = dot(d1, r)
    e = dot(d2, d2)
    f = dot(d2, r)
    d = a * e - b * b
    parallel = jnp.abs(d) < eps
    safe = jnp.where(parallel, 1.0, d)
    s = (b * f - c * e) / safe
    t = (a * f - b * c) / safe
    f1 = tuple(pp + s * dd for pp, dd in zip(p1, d1))
    f2 = tuple(pp + t * dd for pp, dd in zip(p2, d2))
    mid1 = tuple((pp + qq) * 0.5 for pp, qq in zip(p1, q1))
    foot = _foot_pl(*mid1, *p2, *q2, eps)
    out1 = tuple(jnp.where(parallel, m, ff) for m, ff in zip(mid1, f1))
    out2 = tuple(jnp.where(parallel, ff2, ff) for ff2, ff in zip(foot, f2))
    return out1, out2


def _polygon_crosses_rows(xs, ys, px, py, valid, n_valid):
    """Cyclic edge crosses of the front-sorted polygon rows (ref
    :1289-1298): xs/ys are (N, B) SORTED member coords (members first),
    px/py (B,), n_valid (B,).  Returns (N, B) crosses, zero on padding."""
    n = xs.shape[0]
    ridx = jnp.arange(n)[:, None]
    # successor row: i+1, wrapping the (n_valid-1)-th row back to row 0
    xs_roll = jnp.concatenate([xs[1:], xs[:1]], axis=0)
    ys_roll = jnp.concatenate([ys[1:], ys[:1]], axis=0)
    wrap = ridx == (n_valid[None, :] - 1)
    xs_n = jnp.where(wrap, xs[0:1, :], xs_roll)
    ys_n = jnp.where(wrap, ys[0:1, :], ys_roll)
    c = (xs_n - xs) * (py[None, :] - ys) - (ys_n - ys) * (px[None, :] - xs)
    return jnp.where(valid, c, 0.0)


def _is_inside_pf_rows(sx, sy, sz, px, py, pz, valid, n_valid, eps_zero):
    """IS_INSIDE_PF (ref :1271-1337) on sorted polygon rows: XOY crosses
    with 1e-12 clamp, the all-nonpositive fallback to XOZ, outside iff a
    strict sign flip vs the first element exists."""
    cxy = _polygon_crosses_rows(sx, sy, px, py, valid, n_valid)
    cxy = jnp.where(jnp.abs(cxy) < eps_zero, 0.0, cxy)
    use_xz = ~jnp.any(cxy > 1e-15, axis=0)                     # (B,)
    cxz = _polygon_crosses_rows(sx, sz, px, pz, valid, n_valid)
    c = jnp.where(use_xz[None, :], cxz, cxy)
    flips = (c[0:1, :] * c) < 0.0
    return ~jnp.any(flips & valid, axis=0)                     # (B,)


def derive_contact_rows(p1, p2, normal, cfg: GJKEPAConfig,
                        mask1=None, mask2=None):
    """Batched contact post-processing: (B,N1,3),(B,N2,3),(B,3) ->
    (npts (B,2,3), cpoint (B,3), normal (B,3), ctype (B,) int32).

    Output-identical to ``jax.vmap(api.derive_contact)`` (the differential
    tests assert exact agreement); see the module docstring for why the
    layout differs."""
    fdt = p1.dtype
    eps = cfg.eps_coincide
    epz = cfg.eps_zero
    b = p1.shape[0]

    def rows(p):
        # (B, N, 3) -> three (N, B) component arrays (one 2-D transpose
        # each; minor dim B stays packed)
        return p[:, :, 0].T, p[:, :, 1].T, p[:, :, 2].T

    x1, y1, z1 = rows(p1)
    x2, y2, z2 = rows(p2)
    m1 = None if mask1 is None else mask1.T
    m2 = None if mask2 is None else mask2.T
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]

    def dots_of(x, y, z, m, dx, dy, dz):
        d = x * dx[None, :] + y * dy[None, :] + z * dz[None, :]
        return jnp.where(m, d, -jnp.inf) if m is not None else d

    dots1 = dots_of(x1, y1, z1, m1, nx, ny, nz)
    dots2 = dots_of(x2, y2, z2, m2, -nx, -ny, -nz)

    def argmax_extract(dots, x, y, z):
        i = jnp.argmax(dots, axis=0, keepdims=True)
        oh = jnp.arange(dots.shape[0])[:, None] == i
        pick = lambda a: jnp.sum(jnp.where(oh, a, 0.0), axis=0)  # noqa: E731
        return pick(x), pick(y), pick(z)

    # -- nearest points (ref :813-855) --------------------------------------
    np1 = argmax_extract(dots1, x1, y1, z1)
    np2 = argmax_extract(dots2, x2, y2, z2)
    npts = jnp.stack([jnp.stack(np1, axis=1), jnp.stack(np2, axis=1)], axis=1)

    # -- support sets at the 0.1 clustering tol (ref :471-472, :509-529) ----
    def support_set(dots, m):
        s = dots > jnp.max(dots, axis=0, keepdims=True) - cfg.support_set_tol
        if m is not None:
            s = s & m
        return s

    set1 = support_set(dots1, m1)
    set2 = support_set(dots2, m2)
    n1 = jnp.sum(set1, axis=0)
    n2 = jnp.sum(set2, axis=0)
    rank1 = jnp.cumsum(set1.astype(jnp.int32), axis=0) - 1
    rank2 = jnp.cumsum(set2.astype(jnp.int32), axis=0) - 1

    a0 = _nth_member(set1, rank1, 0, (x1, y1, z1))
    a1 = _nth_member(set1, rank1, 1, (x1, y1, z1))
    a2 = _nth_member(set1, rank1, 2, (x1, y1, z1))
    b0 = _nth_member(set2, rank2, 0, (x2, y2, z2))
    b1 = _nth_member(set2, rank2, 1, (x2, y2, z2))
    b2 = _nth_member(set2, rank2, 2, (x2, y2, z2))

    def centroid(st, x, y, z, n):
        c = jnp.maximum(n, 1).astype(fdt)
        msum = lambda a: jnp.sum(jnp.where(st, a, 0.0), axis=0) / c  # noqa: E731
        return msum(x), msum(y), msum(z)

    cen1 = centroid(set1, x1, y1, z1, n1)
    cen2 = centroid(set2, x2, y2, z2, n2)

    version = cfg.version
    if version == 2:
        # case_01: vertex-vertex midpoint (:531-541)
        c01 = tuple((a + bb) * 0.5 for a, bb in zip(a0, b0))
        # case_03: edge-edge -> midpoint of line-line feet (:554-572)
        f1, f2 = _foot_ll(a0, a1, b0, b1, epz)
        c03 = tuple((u + v) * 0.5 for u, v in zip(f1, f2))

        def case_04(sx, sy, sz, st, nn, cen, first3, edge0, edge1):
            # SORT_CLOCK (ref :1513-1575): CCW angle from member 0 around
            # the centroid; member 0 pinned first; input order when all
            # members coincide; padding rows last.
            p0x, p0y, p0z = first3[0]
            p1x, p1y, p1z = first3[1]
            p2x, p2y, p2z = first3[2]
            e1 = (p1x - p0x, p1y - p0y, p1z - p0z)
            e2 = (p2x - p0x, p2y - p0y, p2z - p0z)
            nplx = e1[1] * e2[2] - e1[2] * e2[1]
            nply = e1[2] * e2[0] - e1[0] * e2[2]
            nplz = e1[0] * e2[1] - e1[1] * e2[0]
            v0x, v0y, v0z = p0x - cen[0], p0y - cen[1], p0z - cen[2]
            # w = normal x v0
            wx = nply * v0z - nplz * v0y
            wy = nplz * v0x - nplx * v0z
            wz = nplx * v0y - nply * v0x
            vx, vy, vz = sx - cen[0][None, :], sy - cen[1][None, :], sz - cen[2][None, :]
            yy = vx * wx[None, :] + vy * wy[None, :] + vz * wz[None, :]
            xx = vx * v0x[None, :] + vy * v0y[None, :] + vz * v0z[None, :]
            two_pi = 2.0 * jnp.pi
            ang = jnp.mod(jnp.arctan2(yy, xx) + two_pi, two_pi)
            rk = jnp.cumsum(st.astype(jnp.int32), axis=0) - 1
            ang = jnp.where(st & (rk == 0), -1.0, ang)         # member 0 first
            # all-coincident: keep input (compacted) order (:1521)
            same = ~jnp.any(
                st & ((jnp.abs(sx - p0x[None, :]) > epz)
                      | (jnp.abs(sy - p0y[None, :]) > epz)
                      | (jnp.abs(sz - p0z[None, :]) > epz)), axis=0)
            ang = jnp.where(same[None, :], rk.astype(fdt), ang)
            ang = jnp.where(st, ang, jnp.inf)                  # padding last
            order = jnp.argsort(ang, axis=0, stable=True)
            ssx, ssy, ssz = _row_permute((sx, sy, sz), order)
            valid_rows = jnp.arange(sx.shape[0])[:, None] < nn[None, :]
            in0 = _is_inside_pf_rows(ssx, ssy, ssz, *edge0, valid_rows, nn, epz)
            in1 = _is_inside_pf_rows(ssx, ssy, ssz, *edge1, valid_rows, nn, epz)
            cnt_in = in0.astype(jnp.int32) + in1.astype(jnp.int32)
            foot = _foot_pl(*cen, *edge0, *edge1, epz)         # case_04_1
            mid = tuple((u + v) * 0.5 for u, v in zip(edge0, edge1))
            return tuple(jnp.where(cnt_in == 0, f, m)
                         for f, m in zip(foot, mid))

        c04_p1poly = case_04(x1, y1, z1, set1, n1, cen1, (a0, a1, a2), b0, b1)
        c04_p2poly = case_04(x2, y2, z2, set2, n2, cen2, (b0, b1, b2), a0, a1)
        c05 = cen1                                             # (:672-694)

        def sel(cond, t, f):
            return tuple(jnp.where(cond, a, bb) for a, bb in zip(t, f))

        res = sel((n1 == 1) & (n2 == 1), c01,
                  sel((n1 == 1) & (n2 >= 2), a0,
                      sel((n1 >= 2) & (n2 == 1), b0,
                          sel((n1 == 2) & (n2 == 2), c03,
                              sel((n1 == 2) & (n2 >= 3), c04_p2poly,
                                  sel((n1 >= 3) & (n2 == 2), c04_p1poly,
                                      c05))))))
        cpoint = jnp.stack(res, axis=1)
        out_normal = normal
    elif version == 1:
        # sloppy sequential top-2 scans (ref :722-747), all lanes at once
        def scan2(dots, m):
            nrows = dots.shape[0]

            def step(i, c):
                mx, i1, i2 = c
                di = lax.dynamic_slice_in_dim(dots, i, 1, axis=0)[0]
                upd = di > mx - eps
                if m is not None:
                    mi = lax.dynamic_slice_in_dim(m, i, 1, axis=0)[0]
                    upd = upd & mi
                return (jnp.where(upd, di, mx), jnp.where(upd, i, i1),
                        jnp.where(upd, i1, i2))

            neg = jnp.full((b,), -jnp.inf, fdt)
            ii = jnp.full((b,), -1, jnp.int32)
            _, i1, i2 = lax.fori_loop(0, nrows, step, (neg, ii, ii))
            i2 = jnp.where(i2 < 0, i1, i2)
            return i1, i2

        a_1, a_2 = scan2(dots1, m1)
        b_1, b_2 = scan2(dots2, m2)
        single1 = a_1 == a_2
        single2 = b_1 == b_2

        def extract(x, y, z, i):
            oh = jnp.arange(x.shape[0])[:, None] == i[None, :]
            pick = lambda a: jnp.sum(jnp.where(oh, a, 0.0), axis=0)  # noqa: E731
            return pick(x), pick(y), pick(z)

        pa = extract(x1, y1, z1, a_1)
        pb = extract(x2, y2, z2, b_1)
        case1 = tuple((u + v) * 0.5 for u, v in zip(pa, pb))
        case2 = tuple(jnp.where(single1, u, v) for u, v in zip(pa, pb))
        case3 = cen1                                            # 0.1-set mean
        res = tuple(
            jnp.where(single1 & single2, c1,
                      jnp.where(single1 ^ single2, c2, c3))
            for c1, c2, c3 in zip(case1, case2, case3))
        cpoint = jnp.stack(res, axis=1)
        out_normal = normal
    elif version == 3:
        def scan1(dots):
            nrows = dots.shape[0]

            def step(i, c):
                mx, idx = c
                di = lax.dynamic_slice_in_dim(dots, i, 1, axis=0)[0]
                upd = di > mx - eps
                return jnp.where(upd, di, mx), jnp.where(upd, i, idx)

            neg = jnp.full((b,), -jnp.inf, fdt)
            _, idx = lax.fori_loop(0, nrows, step,
                                   (neg, jnp.zeros((b,), jnp.int32)))
            return idx

        idx = scan1(dots2)
        oh = jnp.arange(x2.shape[0])[:, None] == idx[None, :]
        pick = lambda a: jnp.sum(jnp.where(oh, a, 0.0), axis=0)  # noqa: E731
        px_, py_ = pick(x2), pick(y2)
        if m1 is not None:
            zmean = (jnp.sum(jnp.where(m1, z1, 0.0), axis=0)
                     / jnp.maximum(jnp.sum(m1, axis=0), 1))
        else:
            zmean = jnp.mean(z1, axis=0)
        cpoint = jnp.stack([px_, py_, zmean.astype(fdt)], axis=1)
        nl = jnp.sqrt(nx * nx + ny * ny)
        inv = 1.0 / jnp.where(nl > 0.0, nl, 1.0)
        zz = jnp.zeros_like(nx)
        out_normal = jnp.stack(
            [jnp.where(nl > 0.0, nx * inv, nx),
             jnp.where(nl > 0.0, ny * inv, ny), zz], axis=1)
    else:
        raise ValueError(f"unknown contact-point version {version!r} "
                         "(reference supports 1, 2, 3; ref :329-340)")

    # -- contact type (ref :353-413), with the (possibly rewritten) normal --
    onx, ony, onz = out_normal[:, 0], out_normal[:, 1], out_normal[:, 2]
    td1 = dots_of(x1, y1, z1, m1, onx, ony, onz)
    td2 = dots_of(x2, y2, z2, m2, -onx, -ony, -onz)
    tset1 = td1 > jnp.max(td1, axis=0, keepdims=True) - cfg.face_contact_tol
    tset2 = td2 > jnp.max(td2, axis=0, keepdims=True) - cfg.face_contact_tol
    if m1 is not None:
        tset1 = tset1 & m1
    if m2 is not None:
        tset2 = tset2 & m2
    cc = jnp.sum(tset1, axis=0)
    dd = jnp.sum(tset2, axis=0)
    ctype = jnp.where((cc >= 3) & (dd >= 3), jnp.int32(2), jnp.int32(1))

    return npts, cpoint, out_normal, ctype
