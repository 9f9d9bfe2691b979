"""End-to-end narrow-phase tests: hulls, properties, batching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig, Status, gjkepa, gjkepa_batch
from tests.conftest import cube, random_hull

CFG = GJKEPAConfig()


def q(p1, p2, **kw):
    return gjkepa(jnp.asarray(p1), jnp.asarray(p2), **kw)


class TestBasics:
    def test_overlapping_cubes(self):
        r = q(cube([0, 0, 0]), cube([0.5, 0, 0]))
        assert bool(r.hit)
        assert float(r.depth) == pytest.approx(0.5, abs=1e-9)
        np.testing.assert_allclose(np.abs(r.normal), [1, 0, 0], atol=1e-9)
        assert int(r.colli_type) == 2  # face-face
        assert int(r.status) == Status.HIT

    def test_identical_cubes_full_overlap(self):
        r = q(cube([0, 0, 0]), cube([0, 0, 0]))
        assert bool(r.hit)
        assert float(r.depth) == pytest.approx(1.0, abs=1e-9)

    def test_separated_cubes(self):
        # centers 2.0 apart: inside the broadphase envelope
        # (r1 + r2 + 1.0 ~ 2.73) so GJK itself must declare the miss
        r = q(cube([0, 0, 0]), cube([2.0, 0, 0]))
        assert not bool(r.hit)
        assert int(r.status) == Status.MISS_GJK
        # miss outputs zeroed like the reference (:65-71)
        assert float(r.depth) == 0.0
        np.testing.assert_array_equal(r.normal, np.zeros(3))
        np.testing.assert_array_equal(r.contact_point, np.zeros(3))
        # separation lower bound is positive and <= true gap (1.0)
        assert 0.0 < float(r.distance) <= 1.0 + 1e-9

    def test_far_cubes_broadphase(self):
        r = q(cube([0, 0, 0]), cube([100.0, 0, 0]))
        assert not bool(r.hit)
        assert int(r.status) == Status.MISS_BROADPHASE
        assert int(r.gjk_iters) == 0 and int(r.epa_iters) == 0

    def test_vertex_on_face_touch(self):
        # tetra apex touching a cube face: depth ~ 0
        tetra = np.array([[0.0, 0, 0], [-1, 0.5, 0], [-1, -0.5, 0.5], [-1, -0.5, -0.5]])
        r = q(cube([0.5, 0, 0]), tetra)
        if bool(r.hit):  # touching is epsilon-sensitive by design
            assert float(r.depth) == pytest.approx(0.0, abs=1e-6)

    def test_deep_penetration(self):
        r = q(cube([0, 0, 0], half=1.0), cube([0.1, 0.05, 0.0], half=0.25))
        assert bool(r.hit)
        # small cube fully inside: depth = distance from small cube's far
        # face to big cube's near face = 1.0 - (0.1+0.25) ... along x; but
        # minimal exit direction may be any axis; check property instead.
        assert float(r.depth) > 0.5

    def test_contact_versions_run(self):
        p1, p2 = cube([0, 0, 0]), cube([0.6, 0.1, 0.0])
        for v in (1, 2, 3):
            r = q(p1, p2, cfg=CFG.replace(version=v))
            assert bool(r.hit)
            assert np.isfinite(np.asarray(r.contact_point)).all()
        with pytest.raises(ValueError):
            q(p1, p2, cfg=CFG.replace(version=7))

    def test_version3_normal_in_xy_plane(self):
        r = q(cube([0, 0, 0.3]), cube([0.4, 0.2, 0.0]), cfg=CFG.replace(version=3))
        if bool(r.hit):
            assert float(r.normal[2]) == pytest.approx(0.0, abs=1e-12)
            assert float(jnp.linalg.norm(r.normal)) == pytest.approx(1.0, rel=1e-9)


class TestProperties:
    """Property tests per SURVEY.md §4.2."""

    def test_separation_property(self, rng):
        """Translating B by depth*normal (plus slack) separates the pair."""
        checked = 0
        for i in range(40):
            a = random_hull(rng, 16, center=rng.normal(size=3) * 0.5)
            b = random_hull(rng, 16, center=rng.normal(size=3) * 0.5)
            r = q(a, b)
            if not bool(r.hit) or float(r.depth) < 1e-6:
                continue
            checked += 1
            n = np.asarray(r.normal)
            # EPA normal points from the closest face outward; moving B along
            # -normal... direction convention: support(normal) maximizes A-B,
            # so translating B by +depth*normal removes the overlap.
            b2 = b + (float(r.depth) + 1e-3) * n
            r2 = q(a, b2)
            assert not bool(r2.hit) or float(r2.depth) < 5e-3, (
                f"iter {i}: depth {float(r.depth)} -> {float(r2.depth)}")
        assert checked >= 5

    def test_pair_swap_symmetry(self, rng):
        """Swapping the pair flips the normal and preserves hit + depth."""
        for _ in range(20):
            a = random_hull(rng, 12, center=rng.normal(size=3) * 0.4)
            b = random_hull(rng, 12, center=rng.normal(size=3) * 0.4)
            ra, rb = q(a, b), q(b, a)
            if float(ra.depth) < 1e-6 or float(rb.depth) < 1e-6:
                continue  # boundary-of-hit: heuristic verdicts may differ
            assert bool(ra.hit) == bool(rb.hit)
            if bool(ra.hit):
                assert float(ra.depth) == pytest.approx(float(rb.depth), abs=1e-5)

    def test_rigid_translation_invariance(self, rng):
        t = rng.normal(size=3) * 10
        a = random_hull(rng, 16)
        b = random_hull(rng, 16, center=[0.3, 0, 0])
        r1, r2 = q(a, b), q(a + t, b + t)
        assert bool(r1.hit) == bool(r2.hit)
        if bool(r1.hit):
            assert float(r1.depth) == pytest.approx(float(r2.depth), abs=1e-6)

    def test_depth_matches_known_overlap(self, rng):
        """Axis-aligned cubes at varying offsets: analytic depth."""
        for dx in (0.05, 0.3, 0.7, 0.95):
            r = q(cube([0, 0, 0]), cube([dx, 0, 0]))
            assert bool(r.hit)
            assert float(r.depth) == pytest.approx(1.0 - dx, abs=1e-8), f"dx={dx}"


class TestBatch:
    def test_vmap_matches_single(self, rng):
        B = 32
        p1 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 0.6)
                       for _ in range(B)])
        p2 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 0.6)
                       for _ in range(B)])
        rb = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2))
        for i in range(B):
            ri = q(p1[i], p2[i])
            assert bool(rb.hit[i]) == bool(ri.hit), i
            np.testing.assert_allclose(rb.depth[i], ri.depth, atol=1e-12)
            np.testing.assert_allclose(rb.normal[i], ri.normal, atol=1e-12)
            np.testing.assert_allclose(rb.contact_point[i], ri.contact_point,
                                       atol=1e-12)

    def test_masked_padding_equals_unpadded(self, rng):
        a = random_hull(rng, 12)
        b = random_hull(rng, 12, center=[0.4, 0, 0])
        pad = np.zeros((4, 3))
        a_pad = np.concatenate([a, pad])
        b_pad = np.concatenate([b, pad])
        m = np.arange(16) < 12
        r1 = q(a, b)
        r2 = gjkepa(jnp.asarray(a_pad), jnp.asarray(b_pad),
                    mask1=jnp.asarray(m), mask2=jnp.asarray(m))
        assert bool(r1.hit) == bool(r2.hit)
        np.testing.assert_allclose(r1.depth, r2.depth, atol=1e-12)
        np.testing.assert_allclose(r1.contact_point, r2.contact_point, atol=1e-12)

    def test_no_nans_anywhere(self, rng):
        B = 64
        p1 = np.stack([random_hull(rng, 8, center=rng.normal(size=3) * 2)
                       for _ in range(B)])
        p2 = np.stack([random_hull(rng, 8, center=rng.normal(size=3) * 2)
                       for _ in range(B)])
        r = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2))
        for leaf in r:
            assert np.isfinite(np.asarray(leaf, dtype=np.float64)).all()

    def test_f32_mode_runs(self, rng):
        cfg = GJKEPAConfig.for_f32()
        r = gjkepa(jnp.asarray(cube([0, 0, 0]), jnp.float32),
                   jnp.asarray(cube([0.5, 0, 0]), jnp.float32), cfg=cfg)
        assert bool(r.hit)
        assert float(r.depth) == pytest.approx(0.5, abs=1e-4)
        assert r.depth.dtype == jnp.float32

    def test_iteration_caps_respected(self, rng):
        B = 16
        p1 = np.stack([random_hull(rng, 8) for _ in range(B)])
        p2 = np.stack([random_hull(rng, 8, center=[0.2, 0, 0]) for _ in range(B)])
        r = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2))
        assert (np.asarray(r.gjk_iters) <= CFG.gjk_max_iters).all()
        assert (np.asarray(r.epa_iters) <= CFG.epa_max_iters).all()
