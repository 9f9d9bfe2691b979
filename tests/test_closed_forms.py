"""Closed-form narrow-phase answers + the smooth-pair EPA polish.

  * box-box SAT (15 axes = the face normals of the box-box Minkowski
    difference: exact MTV depth/normal) — validated against the exact
    Minkowski-hull depth (scipy ConvexHull of the 64 corner differences,
    an INDEPENDENT oracle sharing no code with the implementation);
  * sphere-cylinder (point vs solid cylinder, either order) — validated
    against refined support-function sampling (the penetration depth IS
    min over unit d of h(d) = h_A(d) + h_B(-d); sampling + local
    refinement brackets it to ~1e-6);
  * the EPA + support-function-descent polish for every analytic pair
    that still reaches EPA (all have a curved side) — its depth must be
    closer to ground truth than converged float32 EPA alone.

Ground-truth helper: h_local per kind (sphere r|v|, box sum h_i|v_i|,
capsule r|v| + H|v_z|, cylinder R|v_xy| + H|v_z|), world form
h(d) = h_local(R^T d) + d.pos — closed forms of the support values the
reference computes by vertex scan (ref :1030-1062).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gjkepa import GJKEPAConfig, collide_shapes_batch
from gjkepa.models.shapes import (BOX, CAPSULE, CYLINDER, SPHERE, boxes,
                                  capsules, concat_shapes, cylinders,
                                  spheres)
from gjkepa.ops.closed_forms import closed_form_shape_pairs

CFG = GJKEPAConfig.for_f32()


def _rots(rng, k):
    ms = []
    for _ in range(k):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        ms.append(q)
    return np.stack(ms).astype(np.float32)


def _h_local(kind, params, v):
    """Support value of one shape in its local frame, rows of v: (M, 3)."""
    if kind == SPHERE:
        return params[0] * np.linalg.norm(v, axis=1)
    if kind == BOX:
        return np.abs(v) @ params[:3]
    if kind == CAPSULE:
        return params[0] * np.linalg.norm(v, axis=1) + params[1] * np.abs(v[:, 2])
    if kind == CYLINDER:
        return (params[0] * np.hypot(v[:, 0], v[:, 1])
                + params[1] * np.abs(v[:, 2]))
    raise ValueError(kind)


def _h_pair(shape_a, shape_b, i, D):
    """h_{A(-)B}(d) for pair i over direction rows D (unit)."""
    ka, pa, xa, ra = (int(shape_a.kind[i]), np.asarray(shape_a.params[i]),
                      np.asarray(shape_a.pos[i]), np.asarray(shape_a.rot[i]))
    kb, pb, xb, rb = (int(shape_b.kind[i]), np.asarray(shape_b.params[i]),
                      np.asarray(shape_b.pos[i]), np.asarray(shape_b.rot[i]))
    return (_h_local(ka, pa, D @ ra) + D @ xa
            + _h_local(kb, pb, (-D) @ rb) - D @ xb)


def _true_depth(rng, a, b, i, n0=20000, rounds=12):
    """min_d h(d) by sampling + local refinement (handles the kinked
    minima of cylinder support functions where plain sampling has
    first-order error)."""
    D = rng.normal(size=(n0, 3))
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    h = _h_pair(a, b, i, D)
    best = D[int(h.argmin())]
    s = 0.1
    for _ in range(rounds):
        P = best[None, :] + s * rng.normal(size=(2000, 3))
        P /= np.linalg.norm(P, axis=1, keepdims=True)
        hv = _h_pair(a, b, i, P)
        j = int(hv.argmin())
        if hv[j] < _h_pair(a, b, i, best[None, :])[0]:
            best = P[j]
        s *= 0.5
    return float(_h_pair(a, b, i, best[None, :])[0])


def test_box_box_sat_exact_vs_minkowski_hull(rng):
    """SAT depth == exact Minkowski-difference-hull depth (independent
    scipy oracle) to f32 eps; hit verdicts identical."""
    from scipy.spatial import ConvexHull

    n = 48
    posA = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    posB = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    hA = (0.2 + 0.4 * rng.random((n, 3))).astype(np.float32)
    hB = (0.2 + 0.4 * rng.random((n, 3))).astype(np.float32)
    rA, rB = _rots(rng, n), _rots(rng, n)
    A = boxes(jnp.asarray(hA), pos=jnp.asarray(posA), rot=jnp.asarray(rA))
    B = boxes(jnp.asarray(hB), pos=jnp.asarray(posB), rot=jnp.asarray(rB))
    handled, hit, depth, normal, gap, status = (
        np.asarray(x) for x in closed_form_shape_pairs(A, B, CFG.broadphase_tol))
    assert handled.all()
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    n_checked = 0
    for i in range(n):
        va = posA[i] + (corners * hA[i]) @ rA[i].T
        vb = posB[i] + (corners * hB[i]) @ rB[i].T
        mink = (va[:, None, :] - vb[None, :, :]).reshape(-1, 3)
        eq = ConvexHull(mink.astype(np.float64)).equations
        if (eq[:, 3] > 1e-9).any():          # origin outside: no penetration
            assert not hit[i]
            continue
        td = float((-eq[:, 3]).min())
        assert hit[i], (i, td)
        assert abs(depth[i] - td) < 1e-5, (i, depth[i], td)
        n_checked += 1
    assert n_checked >= 10


def test_sphere_cylinder_exact_vs_sampled_truth(rng):
    n = 48
    A = spheres(jnp.asarray((0.3 + 0.4 * rng.random(n)).astype(np.float32)),
                pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.5))
    B = cylinders(jnp.asarray((0.3 + 0.4 * rng.random(n)).astype(np.float32)),
                  jnp.asarray((0.3 + 0.4 * rng.random(n)).astype(np.float32)),
                  pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.5),
                  rot=jnp.asarray(_rots(rng, n)))
    handled, hit, depth, normal, gap, status = (
        np.asarray(x) for x in closed_form_shape_pairs(A, B, CFG.broadphase_tol))
    assert handled.all()
    n_deep = 0
    for i in range(n):
        td = _true_depth(rng, A, B, i)
        if td <= 1e-4:
            continue
        assert abs(depth[i] - td) < 1e-5, (i, depth[i], td)
        n_deep += 1
    assert n_deep >= 10


def test_closed_form_known_geometry():
    """Hand-checkable fixtures for the new closed forms."""
    a = concat_shapes(
        spheres([1.0], pos=np.array([[0, 0, 1.2]], np.float32)),
        boxes(np.array([[0.5, 0.5, 0.5]], np.float32)),
        spheres([0.5], pos=np.array([[0.2, 0, 0]], np.float32)),
    )
    b = concat_shapes(
        cylinders([1.0], [0.5]),
        boxes(np.array([[0.5, 0.5, 0.5]], np.float32),
              pos=np.array([[0.8, 0, 0]], np.float32)),
        cylinders([1.0], [1.0]),
    )
    handled, hit, depth, normal, gap, status = (
        np.asarray(x) for x in closed_form_shape_pairs(a, b, CFG.broadphase_tol))
    assert handled.all() and hit.all()
    # sphere r=1 over cylinder top cap: depth = 1 - (1.2 - 0.5)
    np.testing.assert_allclose(depth, [0.3, 0.2, 1.3], atol=1e-6)
    np.testing.assert_allclose(normal[0], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(normal[1], [1, 0, 0], atol=1e-6)
    # sphere on the axis-side inside: lateral exit toward -x
    np.testing.assert_allclose(normal[2], [-1, 0, 0], atol=1e-6)


def test_polish_on_cylinder_pairs(rng):
    """The EPA + polish path must land within 5e-4 of the sampled ground
    truth on deep cylinder-involved pairs — tighter than float32 EPA's
    duplicate-support termination error alone (~2e-3) — with the
    separation property (translate B by depth*normal => no overlap)
    intact."""
    n = 24
    mk_pos = lambda: jnp.asarray(  # noqa: E731
        rng.normal(size=(n, 3)).astype(np.float32) * 0.4)
    r = lambda: jnp.asarray(  # noqa: E731
        (0.3 + 0.4 * rng.random(n)).astype(np.float32))
    A = concat_shapes(
        cylinders(r(), r(), pos=mk_pos(), rot=jnp.asarray(_rots(rng, n))),
        boxes(jnp.asarray(0.2 + 0.4 * rng.random((n, 3)), jnp.float32),
              pos=mk_pos(), rot=jnp.asarray(_rots(rng, n))),
        capsules(r(), r(), pos=mk_pos(), rot=jnp.asarray(_rots(rng, n))),
    )
    B = concat_shapes(
        cylinders(r(), r(), pos=mk_pos(), rot=jnp.asarray(_rots(rng, n))),
        cylinders(r(), r(), pos=mk_pos(), rot=jnp.asarray(_rots(rng, n))),
        cylinders(r(), r(), pos=mk_pos(), rot=jnp.asarray(_rots(rng, n))),
    )
    res = collide_shapes_batch(A, B, cfg=CFG)
    hit = np.asarray(res.hit)
    depth = np.asarray(res.depth)
    normal = np.asarray(res.normal)
    assert hit.sum() >= 20
    checked = 0
    for i in np.flatnonzero(hit):
        td = _true_depth(rng, A, B, i)
        if td <= 5e-3:
            continue
        assert abs(depth[i] - td) < 5e-4, (i, depth[i], td)
        # depth is realized along the reported normal: h(n) == depth and
        # translating B by depth*normal separates (h' >= 0 everywhere)
        hn = float(_h_pair(A, B, i, normal[i][None, :])[0])
        assert abs(hn - depth[i]) < 1e-5, (i, hn, depth[i])
        checked += 1
    assert checked >= 15


def test_boolean_mode_keeps_closed_form_depth(rng):
    """epa_max_iters=0 (boolean-only) still reports exact depth/normal on
    closed-form lanes."""
    n = 16
    A = spheres(jnp.asarray(np.full(n, 0.6, np.float32)),
                pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.4))
    B = spheres(jnp.asarray(np.full(n, 0.6, np.float32)),
                pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.4))
    res = collide_shapes_batch(A, B, cfg=CFG.replace(epa_max_iters=0))
    hit = np.asarray(res.hit)
    assert hit.sum() >= 4
    d = np.linalg.norm(np.asarray(A.pos) - np.asarray(B.pos), axis=1)
    exact = 1.2 - d
    np.testing.assert_allclose(np.asarray(res.depth)[hit], exact[hit], atol=1e-6)
    nrm = np.asarray(res.normal)[hit]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-6)
