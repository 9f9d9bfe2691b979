"""Distance-GJK extension: exact separation + witness points (config 2)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import gjkepa_batch
from gjkepa.api import gjk_distance_batch
from tests.conftest import cube, random_hull


def test_cube_gap_distance():
    p1 = jnp.asarray(np.stack([cube([0, 0, 0]), cube([0, 0, 0])]))
    p2 = jnp.asarray(np.stack([cube([2.0, 0, 0]), cube([0.5, 0, 0])]))
    d = gjk_distance_batch(p1, p2)
    assert float(d.distance[0]) == pytest.approx(1.0, abs=1e-9)
    assert not bool(d.intersecting[0])
    assert bool(d.intersecting[1])
    assert float(d.distance[1]) == 0.0
    # witnesses on the facing faces
    assert float(d.point_a[0, 0]) == pytest.approx(0.5, abs=1e-9)
    assert float(d.point_b[0, 0]) == pytest.approx(1.5, abs=1e-9)


def test_point_face_and_edge_edge_distances():
    # vertex-face: tetra apex at x=1 facing cube face at x=2 -> gap 1
    tet = np.array([[1.0, 0, 0], [0, 0.6, 0.1], [0, -0.5, 0.4], [0, -0.1, -0.6]])
    p2 = cube([2.5, 0, 0])
    d = gjk_distance_batch(jnp.asarray(tet)[None], jnp.asarray(p2)[None])
    assert float(d.distance[0]) == pytest.approx(1.0, abs=1e-9)
    # edge-edge: two unit segments (degenerate hulls) crossing at height 0.3
    e1 = np.array([[-1.0, 0, 0], [1.0, 0, 0]])
    e2 = np.array([[0.0, -1, 0.3], [0.0, 1, 0.3]])
    d = gjk_distance_batch(jnp.asarray(e1)[None], jnp.asarray(e2)[None])
    assert float(d.distance[0]) == pytest.approx(0.3, abs=1e-9)


def test_witnesses_realize_distance(rng):
    B = 32
    p1 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 2.0)
                   for _ in range(B)])
    p2 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 2.0)
                   for _ in range(B)])
    d = gjk_distance_batch(jnp.asarray(p1), jnp.asarray(p2))
    dist = np.asarray(d.distance)
    pa, pb = np.asarray(d.point_a), np.asarray(d.point_b)
    inter = np.asarray(d.intersecting)
    for i in range(B):
        if inter[i]:
            continue
        # |pa - pb| == distance
        assert np.linalg.norm(pa[i] - pb[i]) == pytest.approx(dist[i], abs=1e-7)
        # distance <= every cross vertex-pair distance (it's the min over hulls)
        vmin = np.min(np.linalg.norm(p1[i][:, None] - p2[i][None, :], axis=-1))
        assert dist[i] <= vmin + 1e-9
        # no vertex of either hull lies strictly between the separating planes
        n = (pb[i] - pa[i]) / max(dist[i], 1e-300)
        assert np.max(p1[i] @ n) <= pa[i] @ n + 1e-7
        assert np.min(p2[i] @ n) >= pb[i] @ n - 1e-7


def test_intersecting_agrees_with_gjkepa(rng):
    B = 64
    p1 = np.stack([random_hull(rng, 10, center=rng.normal(size=3) * 0.8)
                   for _ in range(B)])
    p2 = np.stack([random_hull(rng, 10, center=rng.normal(size=3) * 0.8)
                   for _ in range(B)])
    d = gjk_distance_batch(jnp.asarray(p1), jnp.asarray(p2))
    r = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2))
    inter = np.asarray(d.intersecting)
    hit = np.asarray(r.hit)
    dist = np.asarray(d.distance)
    # The engines may disagree only in the epsilon shell around contact
    # (the reference GJK's verdict is heuristic); allow that shell.
    disagree = inter != hit
    assert np.all(dist[disagree] < 1e-3), (
        f"hit/intersect disagreement outside contact shell: {dist[disagree]}")


def test_distance_shapes_batch():
    """Shapes twin of the hull distance query: two unit spheres at center
    distance 3 are separated by exactly 1; touching/overlapping pairs
    report 0."""
    import numpy as np
    import jax.numpy as jnp

    from gjkepa import GJKEPAConfig
    from gjkepa.api import gjk_distance_shapes_batch
    from gjkepa.models import spheres

    a = spheres(jnp.asarray(np.array([1.0, 1.0], np.float32)),
                pos=jnp.asarray(np.zeros((2, 3), np.float32)))
    b = spheres(jnp.asarray(np.array([1.0, 1.0], np.float32)),
                pos=jnp.asarray(np.array([[3.0, 0, 0], [1.5, 0, 0]],
                                         np.float32)))
    r = gjk_distance_shapes_batch(a, b, cfg=GJKEPAConfig.for_f32())
    d = np.asarray(r.distance)
    assert abs(d[0] - 1.0) < 2e-3, d
    assert d[1] < 2e-3, d
    assert bool(r.intersecting[1]) and not bool(r.intersecting[0])
    # witness points straddle the gap along x: sphere A surface at x=1,
    # sphere B surface at x=2
    pa, pb = np.asarray(r.point_a[0]), np.asarray(r.point_b[0])
    assert abs(pa[0] - 1.0) < 2e-3 and abs(pb[0] - 2.0) < 2e-3, (pa, pb)
