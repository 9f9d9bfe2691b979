"""Convex-hull preprocessing: native C++ QuickHull vs scipy, padding, dedup."""

import numpy as np
import pytest

from gjkepa.utils import hull as H

pytestmark = pytest.mark.skipif(
    not H.native_available() and pytest.importorskip("scipy") is None,
    reason="no hull backend available")


def test_cube_hull_is_corners(rng):
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], float)
    interior = rng.uniform(-0.9, 0.9, size=(50, 3))
    pts = np.vstack([corners, interior])
    rng.shuffle(pts)
    faces, vidx = H.convex_hull(pts)
    assert len(vidx) == 8
    hv = np.sort(np.abs(pts[vidx]).ravel())
    np.testing.assert_allclose(hv, 1.0)
    # Euler for triangulated hulls: F = 2V - 4
    assert len(faces) == 2 * len(vidx) - 4


@pytest.mark.skipif(not H.native_available(), reason="C++ build unavailable")
def test_native_matches_scipy_extreme_sets(rng):
    for _ in range(10):
        pts = rng.normal(size=(40, 3))
        _, v_nat = H.convex_hull(pts, backend="native")
        _, v_sci = H.convex_hull(pts, backend="scipy")
        assert set(v_nat.tolist()) == set(v_sci.tolist())


def test_convex_hull_batch(rng):
    pts = rng.normal(size=(8, 24, 3))
    res = H.convex_hull_batch(pts)
    assert len(res) == 8
    for faces, vidx in res:
        assert len(faces) == 2 * len(vidx) - 4
        assert faces.max() < 24


def test_hull_vertices_strips_interior(rng):
    sphere = rng.normal(size=(20, 3))
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    pts = np.vstack([sphere, rng.uniform(-0.3, 0.3, size=(30, 3))])
    hv = H.hull_vertices(pts)
    assert len(hv) <= 20
    # all extreme points lie on the unit sphere
    np.testing.assert_allclose(np.linalg.norm(hv, axis=1), 1.0, atol=1e-9)


def test_degenerate_input_raises():
    flat = np.zeros((10, 3))
    flat[:, 0] = np.arange(10)  # collinear
    with pytest.raises(Exception):
        H.convex_hull(flat)


def test_dedup_vertices():
    soup = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[1, 0, 0], [0, 1, 0], [0, 0, 1]]], float)
    u = H.dedup_vertices(soup)
    assert u.shape == (4, 3)
    # tolerant dedup merges near-duplicates
    soup2 = soup.copy()
    soup2[1, 0, 0] += 1e-9
    assert H.dedup_vertices(soup2, tol=1e-6).shape == (4, 3)


def test_pad_hulls_repeats_first_vertex(rng):
    hs = [rng.normal(size=(k, 3)) for k in (5, 9, 3)]
    padded, mask = H.pad_hulls(hs, pad_to=10)
    assert padded.shape == (3, 10, 3) and mask.shape == (3, 10)
    np.testing.assert_array_equal(mask.sum(axis=1), [5, 9, 3])
    # padding rows repeat vertex 0 => same convex set without a mask
    np.testing.assert_allclose(padded[2, 3:], np.tile(hs[2][0], (7, 1)),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        H.pad_hulls(hs, pad_to=4)
