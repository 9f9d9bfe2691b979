"""Mixed hull-vs-analytic-shape path (api.collide_hull_shape_batch).

Float32 (the precision the GPU runs) vs float64 on all four shape kinds,
plus an EXACT oracle for the hull-vs-sphere case
(depth = sphere radius - point-to-hull distance, computed by convex
projection) — the check that exposed the pre-polish XLA path reporting
-0.06 where the exact depth was 0.59 on an iteration-capped deep smooth
contact.  Every query here runs in float32.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gjkepa import GJKEPAConfig
from gjkepa.api import collide_hull_shape_batch
from gjkepa.models import boxes, capsules, concat_shapes, cylinders, spheres


def _random_hulls(rng, b, n, spread):
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    return (v + rng.normal(size=(b, 1, 3)) * spread).astype(np.float32)


def _mixed_fixture(rng, b):
    p1 = jnp.asarray(_random_hulls(rng, b, 16, spread=0.7))
    q = b // 4
    pos = lambda: jnp.asarray(  # noqa: E731
        rng.normal(size=(q, 3)).astype(np.float32) * 0.7)
    sh = concat_shapes(
        spheres(jnp.asarray((0.3 + 0.4 * rng.random(q)).astype(np.float32)),
                pos=pos()),
        boxes(jnp.asarray((0.25 + 0.3 * rng.random((q, 3))).astype(np.float32)),
              pos=pos()),
        capsules(jnp.asarray((0.2 + 0.2 * rng.random(q)).astype(np.float32)),
                 jnp.asarray((0.25 + 0.25 * rng.random(q)).astype(np.float32)),
                 pos=pos()),
        cylinders(jnp.asarray((0.2 + 0.25 * rng.random(q)).astype(np.float32)),
                  jnp.asarray((0.25 + 0.25 * rng.random(q)).astype(np.float32)),
                  pos=pos()),
    )
    return p1, sh


def test_mixed_f32_matches_f64(rng):
    """Hit verdicts identical; depth within the polish agreement band
    (both precisions refine with the exact-support descent); normals
    aligned."""
    cfg = GJKEPAConfig.for_f32()
    p1, sh = _mixed_fixture(rng, 128)
    sh64 = type(sh)(kind=sh.kind, params=sh.params.astype(jnp.float64),
                    pos=sh.pos.astype(jnp.float64),
                    rot=sh.rot.astype(jnp.float64))
    rf = collide_hull_shape_batch(p1, sh, cfg=cfg)
    rx = collide_hull_shape_batch(p1.astype(jnp.float64), sh64,
                                  cfg=GJKEPAConfig())
    hf, hx = np.asarray(rf.hit), np.asarray(rx.hit)
    np.testing.assert_array_equal(hf, hx)
    m = hf & hx
    assert m.sum() >= 10
    np.testing.assert_allclose(np.asarray(rf.depth)[m],
                               np.asarray(rx.depth)[m], atol=5e-3)
    na = np.asarray(rf.normal)[m]
    nb = np.asarray(rx.normal)[m]
    dots = np.sum(na * nb, axis=1) / np.maximum(
        np.linalg.norm(na, axis=1) * np.linalg.norm(nb, axis=1), 1e-12)
    assert dots.min() > 0.99, dots.min()
    assert np.isfinite(np.asarray(rf.depth)).all()


def test_mixed_hull_sphere_exact_depth(rng):
    """Hull-vs-sphere depth against the EXACT answer: r - dist(center,
    hull) (center outside) or r + interior clearance (center inside),
    by convex projection (scipy)."""
    scipy_spatial = pytest.importorskip("scipy.spatial")
    from scipy.optimize import minimize

    cfg = GJKEPAConfig.for_f32()
    b = 32
    p1 = jnp.asarray(_random_hulls(rng, b, 16, spread=0.5))
    sh = spheres(jnp.asarray((0.4 + 0.4 * rng.random(b)).astype(np.float32)),
                 pos=jnp.asarray(
                     rng.normal(size=(b, 3)).astype(np.float32) * 0.5))
    rf = collide_hull_shape_batch(p1, sh, cfg=cfg)

    def exact_depth(verts, c, r):
        hull = scipy_spatial.ConvexHull(verts)
        A = hull.equations[:, :3]
        bb = -hull.equations[:, 3]
        s = A @ c - bb
        if (s <= 0).all():
            return r + float(-s.max())
        res = minimize(lambda x: np.sum((x - c) ** 2), x0=verts.mean(0),
                       constraints=[{"type": "ineq",
                                     "fun": lambda x: bb - A @ x}])
        return r - float(np.linalg.norm(res.x - c))

    hits = np.nonzero(np.asarray(rf.hit))[0]
    assert len(hits) >= 5
    for i in hits[:12]:
        t = exact_depth(np.asarray(p1[i], np.float64),
                        np.asarray(sh.pos[i], np.float64),
                        float(sh.params[i, 0]))
        assert abs(float(rf.depth[i]) - t) < 2e-3, (i, float(rf.depth[i]), t)


def test_mixed_separation_contract(rng):
    """Translating the shape by depth * normal (+slack) separates the
    pair — the realized-depth contract of the polished path."""
    cfg = GJKEPAConfig.for_f32()
    p1, sh = _mixed_fixture(rng, 64)
    rf = collide_hull_shape_batch(p1, sh, cfg=cfg)
    hit = np.asarray(rf.hit)
    idx = np.nonzero(hit)[0][:8]
    assert len(idx) >= 3
    shift = np.asarray(rf.normal)[idx] * (np.asarray(rf.depth)[idx]
                                          + 1e-3)[:, None]
    moved = type(sh)(kind=sh.kind[idx], params=sh.params[idx],
                     pos=sh.pos[idx] + shift, rot=sh.rot[idx])
    r2 = collide_hull_shape_batch(p1[idx], moved, cfg=cfg)
    assert not np.asarray(r2.hit).any()


def test_mixed_manifold_box_shape_on_hull_face(rng):
    """Mixed manifold: a cube hull resting on a box SHAPE must produce a
    multi-point manifold whose points lie in the contact interface and
    whose depths match the query depth."""
    from gjkepa import manifold_hull_shape_batch

    cfg = GJKEPAConfig.for_f32()
    half = 0.5
    cube = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                     for z in (-half, half)], np.float32)
    # hull cube sits 0.9 above origin; box shape [1x1x1] centered at origin:
    # overlap slab z in [0.4, 0.5], contact normal ~ -z (A -> B)
    p1 = jnp.asarray(np.stack([cube + np.array([0, 0, 0.9], np.float32)]))
    sh = boxes(jnp.asarray(np.array([[0.5, 0.5, 0.5]], np.float32)),
               pos=jnp.asarray(np.zeros((1, 3), np.float32)))
    r = collide_hull_shape_batch(p1, sh, cfg=cfg)
    assert bool(r.hit[0])
    assert float(r.depth[0]) == pytest.approx(0.1, abs=1e-3)
    m = manifold_hull_shape_batch(p1, sh, r.normal, r.depth, r.hit, cfg=cfg)
    pts = np.asarray(m.points[0])
    keep = np.asarray(m.mask[0])
    assert keep.sum() >= 3, keep
    got = pts[keep]
    # contact points lie in the overlap slab and inside the unit square
    assert np.all(got[:, 2] > 0.3) and np.all(got[:, 2] < 0.6), got
    assert np.all(np.abs(got[:, :2]) < 0.51 + 1e-4), got
    dps = np.asarray(m.depths[0])[keep]
    np.testing.assert_allclose(dps, 0.1, atol=2e-3)
