"""Analytic shape support maps + batched analytic narrow-phase (config 3)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import collide_shapes_batch
from gjkepa.models import (
    ShapeBatch, boxes, capsules, concat_shapes, cylinders, spheres,
)
from gjkepa.ops import support as sup


class TestSupportMaps:
    def test_sphere_support(self):
        d = jnp.array([3.0, 0.0, 4.0])
        np.testing.assert_allclose(sup.sphere_support(d, 2.0), [1.2, 0, 1.6], atol=1e-12)

    def test_box_support(self):
        h = jnp.array([1.0, 2.0, 3.0])
        np.testing.assert_allclose(sup.box_support(jnp.array([0.1, -0.5, 2.0]), h),
                                   [1, -2, 3], atol=1e-12)

    def test_capsule_support(self):
        d = jnp.array([0.0, 0.0, 1.0])
        np.testing.assert_allclose(sup.capsule_support(d, 0.5, 2.0), [0, 0, 2.5],
                                   atol=1e-12)
        d = jnp.array([1.0, 0.0, -0.001])
        s = sup.capsule_support(d, 0.5, 2.0)
        assert float(s[2]) < 0  # lower hemisphere end

    def test_cylinder_support(self):
        d = jnp.array([1.0, 0.0, 0.5])
        np.testing.assert_allclose(sup.cylinder_support(d, 2.0, 1.0), [2, 0, 1],
                                   atol=1e-12)
        # axial direction: rim term vanishes
        d = jnp.array([0.0, 0.0, -1.0])
        np.testing.assert_allclose(sup.cylinder_support(d, 2.0, 1.0), [0, 0, -1],
                                   atol=1e-12)

    def test_supports_maximize_dot(self, rng):
        """Support must maximize <d, x> over a dense sampling of the shape."""
        for _ in range(5):
            d = rng.normal(size=3)
            dn = jnp.asarray(d)
            # sphere sampling
            pts = rng.normal(size=(500, 3))
            pts = 1.7 * pts / np.linalg.norm(pts, axis=1, keepdims=True)
            s = np.asarray(sup.sphere_support(dn, 1.7))
            assert s @ d >= (pts @ d).max() - 1e-9
            # box sampling
            h = np.array([0.5, 1.0, 2.0])
            pts = rng.uniform(-1, 1, size=(500, 3)) * h
            s = np.asarray(sup.box_support(dn, jnp.asarray(h)))
            assert s @ d >= (pts @ d).max() - 1e-9


class TestAnalyticBatch:
    def test_sphere_pairs_known_depth(self):
        a = spheres([1.0] * 3, pos=np.zeros((3, 3)), dtype=jnp.float64)
        b = spheres([1.0] * 3, pos=np.array([[0.5, 0, 0], [1.5, 0, 0], [2.5, 0, 0]]),
                    dtype=jnp.float64)
        r = collide_shapes_batch(a, b)
        np.testing.assert_array_equal(np.asarray(r.hit), [True, True, False])
        # sphere pairs take the closed form (test_sphere_sphere_exact_depth
        # pins it to 1e-12); 2e-4 is the polished-EPA bound on smooth shapes
        assert float(r.depth[0]) == pytest.approx(1.5, abs=2e-4)
        assert float(r.depth[1]) == pytest.approx(0.5, abs=2e-4)
        assert float(r.depth[2]) == 0.0

    def test_mixed_kinds(self):
        a = concat_shapes(
            boxes([[0.5, 0.5, 0.5]], dtype=jnp.float64),
            capsules([0.3], [0.5], dtype=jnp.float64),
            cylinders([0.4], [0.5], dtype=jnp.float64),
        )
        b = spheres([0.5] * 3,
                    pos=np.array([[0.8, 0, 0], [0.6, 0, 0], [0.7, 0, 0]]),
                    dtype=jnp.float64)
        r = collide_shapes_batch(a, b)
        assert np.asarray(r.hit).all()
        np.testing.assert_allclose(np.asarray(r.depth), [0.2, 0.2, 0.2], atol=2e-4)

    def test_rotation_consistency(self, rng):
        """A rotated box vs a sphere: depth invariant under joint rotation."""
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        h = np.array([[0.5, 0.7, 0.9]])
        p_sph = np.array([[1.0, 0.3, 0.2]])
        a1 = boxes(h, dtype=jnp.float64)
        b1 = spheres([0.6], pos=p_sph, dtype=jnp.float64)
        a2 = boxes(h, rot=q[None], dtype=jnp.float64)
        b2 = spheres([0.6], pos=(p_sph @ q.T), dtype=jnp.float64)
        r1 = collide_shapes_batch(a1, b1)
        r2 = collide_shapes_batch(a2, b2)
        assert bool(r1.hit[0]) == bool(r2.hit[0])
        assert float(r1.depth[0]) == pytest.approx(float(r2.depth[0]), abs=1e-5)

    def test_large_mixed_batch_no_nans(self, rng):
        B = 256
        kinds = rng.integers(0, 4, size=B)
        batches = []
        for k in kinds:
            pos = rng.normal(size=(1, 3)) * 1.5
            if k == 0:
                batches.append(spheres([0.5 + rng.random()], pos=pos, dtype=jnp.float64))
            elif k == 1:
                batches.append(boxes(0.3 + rng.random(size=(1, 3)), pos=pos, dtype=jnp.float64))
            elif k == 2:
                batches.append(capsules([0.3], [0.5], pos=pos, dtype=jnp.float64))
            else:
                batches.append(cylinders([0.4], [0.5], pos=pos, dtype=jnp.float64))
        a = concat_shapes(*batches[:B // 2])
        b = concat_shapes(*batches[B // 2:])
        r = collide_shapes_batch(a, b)
        for leaf in r:
            assert np.isfinite(np.asarray(leaf, dtype=np.float64)).all()
        assert 0 < int(np.sum(np.asarray(r.hit))) < B // 2  # plausible mix


class TestMixedHullShape:
    def test_box_shape_equals_its_corner_hull(self, rng):
        """A box as an analytic shape vs as its 8-corner hull must give the
        same hit/depth against a hull opponent."""
        import jax.numpy as jnp
        from gjkepa.api import collide_hull_shape_batch
        from gjkepa import GJKEPAConfig, gjkepa_batch

        cfg = GJKEPAConfig()
        B = 16
        hulls = np.stack([np.random.default_rng(i).normal(size=(12, 3))
                          for i in range(B)])
        hulls /= np.linalg.norm(hulls, axis=-1, keepdims=True)
        hulls += rng.normal(size=(B, 1, 3)) * 0.6
        half = 0.4 + 0.4 * rng.random((B, 3))
        pos = rng.normal(size=(B, 3)) * 0.6
        shp = boxes(half, pos=pos, dtype=jnp.float64)
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)])
        box_hulls = pos[:, None, :] + corners[None] * half[:, None, :]
        r_mixed = collide_hull_shape_batch(jnp.asarray(hulls), shp, cfg=cfg)
        r_hull = gjkepa_batch(jnp.asarray(hulls), jnp.asarray(box_hulls), cfg=cfg)
        np.testing.assert_array_equal(np.asarray(r_mixed.hit),
                                      np.asarray(r_hull.hit))
        m = np.asarray(r_mixed.hit)
        if m.any():
            np.testing.assert_allclose(np.asarray(r_mixed.depth)[m],
                                       np.asarray(r_hull.depth)[m], atol=1e-6)


def test_sphere_sphere_exact_depth():
    """Sphere-sphere pairs bypass EPA's polyhedral approximation."""
    import jax.numpy as jnp
    a = spheres([1.0, 0.7], pos=np.zeros((2, 3)), dtype=jnp.float64)
    b = spheres([1.0, 0.7], pos=np.array([[0.5, 0, 0], [0.0, 1.1, 0]]),
                dtype=jnp.float64)
    r = collide_shapes_batch(a, b)
    assert float(r.depth[0]) == pytest.approx(1.5, abs=1e-12)
    assert float(r.depth[1]) == pytest.approx(0.3, abs=1e-12)
    np.testing.assert_allclose(np.asarray(r.normal[0]), [1, 0, 0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(r.normal[1]), [0, 1, 0], atol=1e-12)
    # witnesses on each surface
    np.testing.assert_allclose(np.asarray(r.nearest_points[0]),
                               [[1, 0, 0], [-0.5, 0, 0]], atol=1e-12)


def test_fuzz_mixed_kind_pairs_f32_vs_f64(rng):
    """Multi-seed fuzz over ALL 16 shape-kind pair combinations (the c3
    bench fixture only exercises same-kind pairs): the float32 path the GPU
    runs (closed forms + polished EPA) must agree with the float64 path on
    hit verdicts and depth for every combination, including rotated
    capsules/cylinders against boxes."""
    from gjkepa import GJKEPAConfig
    from gjkepa.ops.closed_forms import closed_form_shape_pairs

    cfg = GJKEPAConfig.for_f32()

    def as64(s):
        return type(s)(kind=s.kind, params=s.params.astype(jnp.float64),
                       pos=s.pos.astype(jnp.float64),
                       rot=s.rot.astype(jnp.float64))

    for seed in (11, 23):
        a, b = _mixed_16combo_pair(8, seed)
        r32 = collide_shapes_batch(a, b, cfg=cfg)
        r64 = collide_shapes_batch(as64(a), as64(b), cfg=GJKEPAConfig())
        hit32 = np.asarray(r32.hit)
        hit64 = np.asarray(r64.hit)
        np.testing.assert_array_equal(
            hit32, hit64, err_msg=f"seed {seed}: hit verdicts diverge")
        both = hit32 & (np.asarray(r32.status) == 3) \
            & (np.asarray(r64.status) == 3)
        d32, d64 = np.asarray(r32.depth), np.asarray(r64.depth)
        handled = np.asarray(closed_form_shape_pairs(
            a, b, cfg.broadphase_tol)[0])
        # closed-form lanes: exact on both sides, so only f32 rounding
        m0 = both & handled
        np.testing.assert_allclose(
            d32[m0], d64[m0], atol=2e-5,
            err_msg=f"seed {seed}: depth diverges on closed-form lanes")
        # remaining lanes (box-capsule / box-cyl / cap-cyl / cyl-cyl) run
        # EPA + the support-descent polish, an upper bound realized along
        # its direction; f32 EPA terminates on duplicate supports with up
        # to ~2e-3 depth error on smooth surfaces
        m1 = both & ~handled
        assert m1.any()
        np.testing.assert_allclose(
            d32[m1], d64[m1], atol=5e-3,
            err_msg=f"seed {seed}: depth diverges on polished EPA lanes")


def _rand_rots(k, r):
    ms = []
    for _ in range(k):
        q = np.linalg.qr(r.normal(size=(3, 3)))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        ms.append(q)
    return jnp.asarray(np.stack(ms), jnp.float32)


def _batch_of_kind(kind, n, r, spread=0.9):
    pos = jnp.asarray(r.normal(size=(n, 3)).astype(np.float32) * spread)
    rr = _rand_rots(n, r)
    p0 = jnp.asarray((0.3 + 0.4 * r.random(n)).astype(np.float32))
    p1 = jnp.asarray((0.2 + 0.4 * r.random(n)).astype(np.float32))
    if kind == 0:
        return spheres(p0, pos=pos)
    if kind == 1:
        return boxes(jnp.stack([p0, p1, p0], 1), pos=pos, rot=rr)
    if kind == 2:
        return capsules(p0, p1, pos=pos, rot=rr)
    return cylinders(p0, p1, pos=pos, rot=rr)


def _mixed_16combo_pair(n_per_combo, seed):
    r = np.random.default_rng(seed)
    a = concat_shapes(*[_batch_of_kind(ka, n_per_combo, r)
                        for ka in range(4) for _ in range(4)])
    b = concat_shapes(*[_batch_of_kind(kb, n_per_combo, r)
                        for _ in range(4) for kb in range(4)])
    return a, b


def test_shapes_order_invariance(rng):
    """Lanes are independent: a shuffled batch must return exactly the
    shuffled results of the natural batch."""
    from gjkepa import GJKEPAConfig

    cfg = GJKEPAConfig.for_f32()
    q = 32
    pos = lambda: jnp.asarray(  # noqa: E731
        rng.normal(size=(q, 3)).astype(np.float32) * 1.1)
    mk = lambda: concat_shapes(  # noqa: E731
        spheres(jnp.asarray(0.4 + 0.4 * rng.random(q).astype(np.float32)),
                pos=pos()),
        boxes(jnp.asarray(0.3 + 0.4 * rng.random((q, 3)).astype(np.float32)),
              pos=pos()),
        capsules(jnp.asarray(0.2 + 0.2 * rng.random(q).astype(np.float32)),
                 jnp.asarray(0.3 + 0.3 * rng.random(q).astype(np.float32)),
                 pos=pos()),
        cylinders(jnp.asarray(0.2 + 0.3 * rng.random(q).astype(np.float32)),
                  jnp.asarray(0.3 + 0.3 * rng.random(q).astype(np.float32)),
                  pos=pos()),
    )
    a, b = mk(), mk()
    base = collide_shapes_batch(a, b, cfg=cfg)
    perm = rng.permutation(4 * q)
    sh = lambda s: type(s)(kind=s.kind[perm], params=s.params[perm],  # noqa
                           pos=s.pos[perm], rot=s.rot[perm])
    shuf = collide_shapes_batch(sh(a), sh(b), cfg=cfg)
    for field in base._fields:
        np.testing.assert_array_equal(np.asarray(getattr(base, field))[perm],
                                      np.asarray(getattr(shuf, field)),
                                      err_msg=field)


def _np_shape_support(kind, params, pos, rot, d):
    """Vectorized numpy support of one shape batch: (D, 3) dirs x (n,)
    shapes -> (D, n, 3) world support points.  Independent re-derivation of
    the engine's closed-form supports (box/capsule/cylinder) used as the
    audit oracle."""
    dl = np.einsum("nij,di->dnj", np.asarray(rot), d)          # R^T d
    p = np.asarray(params)
    k = int(kind)
    if k == 1:                                                 # box
        s_local = np.where(dl >= 0, p[None, :, :3], -p[None, :, :3])
    else:
        nxy = np.hypot(dl[..., 0], dl[..., 1])
        safe = np.where(nxy > 1e-12, nxy, 1.0)
        if k == 2:                                             # capsule
            nrm = np.linalg.norm(dl, axis=-1)
            nsafe = np.where(nrm > 1e-12, nrm, 1.0)
            core = p[None, :, 0:1] * dl / nsafe[..., None]
            cap = np.where(dl[..., 2] >= 0, p[None, :, 1], -p[None, :, 1])
            s_local = core + np.stack(
                [np.zeros_like(cap), np.zeros_like(cap), cap], axis=-1)
        else:                                                  # cylinder
            sx = np.where(nxy > 1e-12, p[None, :, 0] * dl[..., 0] / safe, 0.0)
            sy = np.where(nxy > 1e-12, p[None, :, 0] * dl[..., 1] / safe, 0.0)
            sz = np.where(dl[..., 2] >= 0, p[None, :, 1], -p[None, :, 1])
            s_local = np.stack([sx, sy, sz], axis=-1)
    return np.einsum("nji,dni->dnj", np.asarray(rot),
                     s_local) + np.asarray(pos)[None]


@pytest.mark.parametrize("ka,kb", [(3, 3), (1, 3), (3, 1), (2, 3), (3, 2),
                                   (1, 2), (2, 1)])
def test_verdict_audit_vs_separating_axis(rng, ka, kb):
    """Independent hit-verdict audit for every kind pair WITHOUT a closed
    form (the GJK/EPA path): a pair is disjoint iff some unit direction d
    has positive Minkowski support h(d) = <s_A(d)-s_B(-d), d>.  Dense
    direction sampling (2048 dirs) gives a one-sided certificate each way:
    min_d h(d) < -tol proves separation (a hit there is a FALSE hit —
    this caught a center-to-center GJK init producing ~800 false
    touching-contact hits per 64k);
    min_d h(d) > margin over all samples makes a miss suspect — the
    margin must account for sampling density: for nearly-touching convex
    bodies the separating cone is arbitrarily narrow, so h can dip below
    zero between samples by ~R * (sample spacing); with 2048 dirs
    (~4 degrees apart) and objects of scale ~1 the sound margin is ~0.15
    (a first version used 1e-4 and flagged a correctly-separated
    box-capsule pair with a 0.02 gap as a "missed hit")."""
    from gjkepa import GJKEPAConfig
    cfg = GJKEPAConfig.for_f32()
    n = 64

    def mk(kind):
        pos = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.9)
        if kind == 1:
            return boxes(jnp.asarray(
                (0.25 + 0.35 * rng.random((n, 3))).astype(np.float32)),
                pos=pos)
        if kind == 2:
            return capsules(
                jnp.asarray((0.2 + 0.2 * rng.random(n)).astype(np.float32)),
                jnp.asarray((0.3 + 0.3 * rng.random(n)).astype(np.float32)),
                pos=pos)
        return cylinders(
            jnp.asarray((0.2 + 0.3 * rng.random(n)).astype(np.float32)),
            jnp.asarray((0.3 + 0.3 * rng.random(n)).astype(np.float32)),
            pos=pos)

    a, b = mk(ka), mk(kb)
    r = collide_shapes_batch(a, b, cfg=cfg)

    dirs = rng.normal(size=(2048, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sa = _np_shape_support(ka, a.params, a.pos, a.rot, dirs)
    sb = _np_shape_support(kb, b.params, b.pos, b.rot, -dirs)
    h = np.einsum("dnj,dj->dn", sa - sb, dirs)                 # (D, n)
    min_h = h.min(axis=0)

    hit = np.asarray(r.hit)
    false_hits = hit & (min_h < -1e-4)     # sampled separating axis: sound
    missed = ~hit & (min_h > 0.15)         # sampling-aware margin (above)
    assert not false_hits.any(), np.nonzero(false_hits)
    assert not missed.any(), np.nonzero(missed)
