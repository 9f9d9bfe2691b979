"""Shapes-path contact contract (ref :47-52 on every public query path).

The reference always emits nearest points, contact point and contact type
after EPA (ref :326-343).  These tests pin the analytic-shapes derivation
(ops.contact_shapes) against the HULL path on box-box pairs represented
both ways: as corner clouds (the reference's native representation,
exercising ops.contact's vertex case trees) and as box params (exercising
the closed-form candidate enumeration).  Same geometry, same normal =>
the two derivations must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig, collide_shapes_batch, gjkepa_batch
from gjkepa.models import boxes


def _corner_cloud(half, pos):
    """Box corners in the same enumeration order as the shapes candidate
    table (sx, sy, sz over (-1, 1) nested) so support-set collection order
    matches between the two representations."""
    h = np.asarray(half, np.float64)
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], np.float64)
    return signs * h + np.asarray(pos, np.float64)


def _box_fixture(rng, n=16, spread=0.8):
    half_a = 0.3 + 0.4 * rng.random((n, 3))
    half_b = 0.3 + 0.4 * rng.random((n, 3))
    pos_a = rng.normal(size=(n, 3)) * spread * 0.3
    pos_b = rng.normal(size=(n, 3)) * spread * 0.3
    return half_a, pos_a, half_b, pos_b


@pytest.mark.slow
@pytest.mark.parametrize("version", [1, 2, 3])
def test_box_pairs_shapes_vs_hull_contact(rng, version):
    half_a, pos_a, half_b, pos_b = _box_fixture(rng)
    n = half_a.shape[0]
    cfg = GJKEPAConfig(version=version)

    p1 = jnp.asarray(np.stack([_corner_cloud(half_a[i], pos_a[i])
                               for i in range(n)]))
    p2 = jnp.asarray(np.stack([_corner_cloud(half_b[i], pos_b[i])
                               for i in range(n)]))
    rh = gjkepa_batch(p1, p2, cfg=cfg)

    a = boxes(jnp.asarray(half_a), pos=jnp.asarray(pos_a), dtype=jnp.float64)
    b = boxes(jnp.asarray(half_b), pos=jnp.asarray(pos_b), dtype=jnp.float64)
    rs = collide_shapes_batch(a, b, cfg=cfg)

    hit_h = np.asarray(rh.hit)
    hit_s = np.asarray(rs.hit)
    np.testing.assert_array_equal(hit_h, hit_s)
    both = hit_h & hit_s
    assert both.sum() >= 3, "fixture should produce hits"

    # depths agree (axis-aligned boxes: SAT/EPA both find the exact axis)
    np.testing.assert_allclose(np.asarray(rs.depth)[both],
                               np.asarray(rh.depth)[both], atol=5e-3)
    # where the two paths chose the SAME normal (sign included), the whole
    # contact surface must agree: identical support sets => identical case
    # tree outcomes.  (Near-cubic boxes can legitimately pick a different
    # minimum axis when two penetrations tie within EPA tolerance.)
    nh = np.asarray(rh.normal)
    ns = np.asarray(rs.normal)
    same_n = both & (np.einsum("ij,ij->i", nh, ns) > 0.999)
    assert same_n.sum() >= 2, "fixture should produce same-normal hits"
    np.testing.assert_array_equal(np.asarray(rs.colli_type)[same_n],
                                  np.asarray(rh.colli_type)[same_n])
    np.testing.assert_allclose(np.asarray(rs.contact_point)[same_n],
                               np.asarray(rh.contact_point)[same_n],
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(rs.nearest_points)[same_n],
                               np.asarray(rh.nearest_points)[same_n],
                               atol=2e-2)


def test_face_face_type_and_point_on_aligned_boxes():
    """Two axis-aligned overlapping boxes: face-face contact (type 2),
    contact point = centroid of A's supporting face (version-2 case_05,
    ref :672-694), nearest points on the two surfaces."""
    cfg = GJKEPAConfig(version=2)
    a = boxes(jnp.asarray([[0.5, 0.5, 0.5]], jnp.float64),
              pos=jnp.asarray([[0.0, 0.0, 0.0]], jnp.float64),
              dtype=jnp.float64)
    b = boxes(jnp.asarray([[0.5, 0.5, 0.5]], jnp.float64),
              pos=jnp.asarray([[0.8, 0.0, 0.0]], jnp.float64),
              dtype=jnp.float64)
    r = collide_shapes_batch(a, b, cfg=cfg)
    assert bool(r.hit[0])
    assert float(r.depth[0]) == pytest.approx(0.2, abs=1e-5)
    np.testing.assert_allclose(np.asarray(r.normal[0]), [1, 0, 0], atol=1e-6)
    assert int(r.colli_type[0]) == 2
    # A's +x face centroid
    np.testing.assert_allclose(np.asarray(r.contact_point[0]), [0.5, 0, 0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r.nearest_points[0, 0]),
                               [0.5, 0, 0], atol=0.51)  # on A's +x face
    assert abs(float(r.nearest_points[0, 0, 0]) - 0.5) < 1e-6
    assert abs(float(r.nearest_points[0, 1, 0]) - 0.3) < 1e-6


def test_sphere_pair_contact_contract():
    """Sphere-sphere: type 1, nearest points on each surface, contact point
    between them."""
    cfg = GJKEPAConfig.for_f32()
    from gjkepa.models import spheres

    a = spheres(jnp.asarray([1.0], jnp.float32),
                pos=jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32))
    b = spheres(jnp.asarray([0.5], jnp.float32),
                pos=jnp.asarray([[1.2, 0.0, 0.0]], jnp.float32))
    r = collide_shapes_batch(a, b, cfg=cfg)
    assert bool(r.hit[0])
    assert int(r.colli_type[0]) == 1
    assert float(r.depth[0]) == pytest.approx(0.3, abs=1e-6)
    np.testing.assert_allclose(np.asarray(r.nearest_points[0, 0]),
                               [1.0, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(r.nearest_points[0, 1]),
                               [0.7, 0, 0], atol=1e-5)


def test_f32_contact_matches_f64(rng):
    """In float32, the precision the GPU runs, collide_shapes_batch agrees
    with its float64 answer on the full contact surface for mixed
    closed-form pairs."""
    from gjkepa.models import concat_shapes, spheres

    cfg = GJKEPAConfig.for_f32()
    n = 16
    pos = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.8)
    radii = jnp.asarray((0.4 + 0.4 * rng.random(n)).astype(np.float32))
    hb = jnp.asarray((0.3 + 0.3 * rng.random((n, 3))).astype(np.float32))
    a = concat_shapes(spheres(radii, pos=pos), boxes(hb, pos=-pos))
    b = concat_shapes(spheres(radii[::-1], pos=-pos), boxes(hb, pos=pos))
    a64, b64 = (type(s)(kind=s.kind, params=s.params.astype(jnp.float64),
                        pos=s.pos.astype(jnp.float64),
                        rot=s.rot.astype(jnp.float64)) for s in (a, b))
    rf = collide_shapes_batch(a, b, cfg=cfg)
    rx = collide_shapes_batch(a64, b64, cfg=GJKEPAConfig())
    hit_f = np.asarray(rf.hit)
    np.testing.assert_array_equal(hit_f, np.asarray(rx.hit))
    both = hit_f
    nh = np.asarray(rx.normal)
    ns = np.asarray(rf.normal)
    same_n = both & (np.einsum("ij,ij->i", nh, ns) > 0.999)
    np.testing.assert_array_equal(np.asarray(rf.colli_type)[same_n],
                                  np.asarray(rx.colli_type)[same_n])
    np.testing.assert_allclose(np.asarray(rf.contact_point)[same_n],
                               np.asarray(rx.contact_point)[same_n],
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(rf.nearest_points)[same_n],
                               np.asarray(rx.nearest_points)[same_n],
                               atol=2e-2)
