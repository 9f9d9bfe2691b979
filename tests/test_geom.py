"""Unit tests for the L1 math kernel against independent numpy formulas."""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa.ops import geom


def test_cross3_matches_numpy(rng):
    a, b = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_allclose(geom.cross3(jnp.asarray(a), jnp.asarray(b)),
                               np.cross(a, b), atol=1e-12)


def test_utzvec_normalizes_and_zeroes():
    v = jnp.array([3.0, 0.0, 4.0])
    np.testing.assert_allclose(geom.utzvec(v), [0.6, 0.0, 0.8], atol=1e-12)
    np.testing.assert_array_equal(geom.utzvec(jnp.zeros(3)), np.zeros(3))
    np.testing.assert_array_equal(geom.utzvec(jnp.full(3, 1e-13)), np.zeros(3))


def test_uninml_plane_normal():
    tri = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    np.testing.assert_allclose(geom.uninml(tri), [0, 0, 1], atol=1e-12)
    # degenerate (collinear) -> zero vector
    tri2 = jnp.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]])
    np.testing.assert_array_equal(geom.uninml(tri2), np.zeros(3))


def test_dist_pf_sign():
    tri = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    assert float(geom.dist_pf_sign(jnp.array([0.0, 0, 2.5]), tri)) == pytest.approx(2.5)
    assert float(geom.dist_pf_sign(jnp.array([0.0, 0, -1.0]), tri)) == pytest.approx(-1.0)
    # degenerate plane -> 0, not a crash (reference STOPs here, :1369-1373)
    tri2 = jnp.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]])
    assert float(geom.dist_pf_sign(jnp.array([0.0, 5, 0]), tri2)) == 0.0


def test_vec_pl_points_from_point_toward_line():
    # Reference orientation: unit(foot - point) (ref :1438).
    line = jnp.array([[0.0, 1, 0], [1.0, 1, 0]])
    p = jnp.zeros(3)
    np.testing.assert_allclose(geom.vec_pl(p, line), [0, 1, 0], atol=1e-12)


def test_foot_pl():
    line = jnp.array([[0.0, 0, 0], [2.0, 0, 0]])
    np.testing.assert_allclose(geom.foot_pl(jnp.array([0.7, 3.0, 1.0]), line),
                               [0.7, 0, 0], atol=1e-12)


def test_foot_ll_skew_and_parallel():
    l1 = jnp.array([[0.0, 0, 0], [1.0, 0, 0]])
    l2 = jnp.array([[0.0, 1, 1], [0.0, -1, 1]])  # crosses x=0 plane at z=1
    feet = geom.foot_ll(l1, l2)
    np.testing.assert_allclose(feet[0], [0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(feet[1], [0, 0, 1], atol=1e-12)
    # parallel: midpoint of line1 + its foot on line2 (ref :1474-1476)
    l3 = jnp.array([[0.0, 2, 0], [1.0, 2, 0]])
    feet2 = geom.foot_ll(l1, l3)
    np.testing.assert_allclose(feet2[0], [0.5, 0, 0], atol=1e-12)
    np.testing.assert_allclose(feet2[1], [0.5, 2, 0], atol=1e-12)


def test_is_inside_pf_xy_polygon():
    sq = jnp.array([[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    assert bool(geom.is_inside_pf(sq, jnp.array([0.5, 0.5, 0.0])))
    assert not bool(geom.is_inside_pf(sq, jnp.array([1.5, 0.5, 0.0])))
    # on the edge: cross = 0 is neutral -> inside
    assert bool(geom.is_inside_pf(sq, jnp.array([1.0, 0.5, 0.0])))


def test_is_inside_pf_xz_fallback():
    # polygon in the XZ plane: XY projection is a degenerate segment
    sq = jnp.array([[0.0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]])
    assert bool(geom.is_inside_pf(sq, jnp.array([0.5, 0.0, 0.5])))
    assert not bool(geom.is_inside_pf(sq, jnp.array([2.0, 0.0, 0.5])))


def test_is_inside_pf_clockwise_interior_uses_xz_quirk():
    # Reference quirk (:1305-1310): only POSITIVE crosses count as "nonzero".
    # An interior point of a clockwise-wound XY polygon makes all crosses
    # negative, so the test falls through to the XZ projection, where an
    # XY-planar polygon degenerates to a segment (all crosses zero) and the
    # point is accepted.  Replicated behavior:
    sq_cw = jnp.array([[0.0, 1, 0], [1, 1, 0], [1, 0, 0], [0, 0, 0]])
    assert bool(geom.is_inside_pf(sq_cw, jnp.array([0.5, 0.5, 0.0])))


def test_is_inside_pf_masked_padding():
    tri = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0],
                     [99.0, 99, 99], [99.0, 99, 99]])
    assert bool(geom.is_inside_pf(tri, jnp.array([0.2, 0.2, 0.0]), n_valid=3))
    assert not bool(geom.is_inside_pf(tri, jnp.array([0.9, 0.9, 0.0]), n_valid=3))


def test_point_in_simplex():
    tetra = jnp.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    assert bool(geom.point_in_simplex(jnp.array([0.1, 0.1, 0.1]), tetra))
    assert not bool(geom.point_in_simplex(jnp.array([1.0, 1.0, 1.0]), tetra))
    # on a face -> 2-D fallback accepts (ref :1247-1260)
    assert bool(geom.point_in_simplex(jnp.array([0.2, 0.2, 0.0]), tetra))
    # in a face plane but outside the face polygon -> rejected
    assert not bool(geom.point_in_simplex(jnp.array([2.0, 2.0, 0.0]), tetra))


def test_overlap():
    pts = jnp.ones((4, 3))
    assert bool(geom.overlap(pts))
    assert not bool(geom.overlap(pts.at[2, 1].add(1e-6)))
    # masked: differing point is padding
    valid = jnp.array([True, True, False, True])
    assert bool(geom.overlap(pts.at[2, 1].add(1.0), valid))


def test_sort_clock_indices_recovers_ccw_order(rng):
    # shuffled regular octagon in a tilted plane
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts2d = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    basis = np.linalg.qr(rng.normal(size=(3, 3)))[0][:, :2]
    pts = pts2d @ basis.T + rng.normal(size=3)
    perm = rng.permutation(8)
    shuffled = pts[perm]
    order = np.asarray(geom.sort_clock_indices(jnp.asarray(shuffled), 8))
    ordered = shuffled[order]
    # must be a cyclic rotation (possibly reflected) of the octagon sequence
    start = perm[order][0] if False else None  # noqa: F841 (clarity)
    seq = [int(np.argmin(np.linalg.norm(pts - q, axis=1))) for q in ordered]
    diffs = np.diff(seq + [seq[0]]) % 8
    assert len(set(diffs.tolist())) == 1  # constant step = +1 or -1 cyclically


def test_sort_clock_indices_padding_last():
    pts = jnp.array([[1.0, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                     [50.0, 50, 50], [60.0, 60, 60]])
    order = np.asarray(geom.sort_clock_indices(pts, 4))
    assert set(order[:4].tolist()) == {0, 1, 2, 3}
    assert order[0] == 0
