"""Multi-chip sharding tests on the 8-virtual-device CPU mesh (SURVEY §4.5)."""

import jax
import jax.numpy as jnp
import numpy as np

from gjkepa import GJKEPAConfig, gjkepa_batch
from gjkepa.parallel import (
    contact_count_sharded, gjkepa_batch_sharded, pair_mesh, shard_pairs,
)
from tests.conftest import cube


def _batch(rng, b):
    p1 = np.stack([cube(rng.normal(size=3) * 1.2) for _ in range(b)])
    p2 = np.stack([cube(rng.normal(size=3) * 1.2) for _ in range(b)])
    return jnp.asarray(p1), jnp.asarray(p2)


def test_virtual_mesh_has_8_devices():
    mesh = pair_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("pairs",)


def test_sharded_matches_unsharded(rng):
    mesh = pair_mesh()
    p1, p2 = _batch(rng, 64)
    p1s, p2s = shard_pairs(mesh, p1, p2)
    rs = gjkepa_batch_sharded(mesh, p1s, p2s)
    ru = gjkepa_batch(p1, p2)
    np.testing.assert_array_equal(np.asarray(rs.hit), np.asarray(ru.hit))
    np.testing.assert_allclose(np.asarray(rs.depth), np.asarray(ru.depth),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(rs.contact_point),
                               np.asarray(ru.contact_point), atol=1e-12)
    # results come back sharded over the pair axis
    assert len(rs.depth.sharding.device_set) == 8


def test_psum_contact_count(rng):
    mesh = pair_mesh()
    p1, p2 = _batch(rng, 64)
    p1s, p2s = shard_pairs(mesh, p1, p2)
    cnt = contact_count_sharded(mesh, p1s, p2s)
    expected = int(jnp.sum(gjkepa_batch(p1, p2).hit))
    assert int(cnt) == expected


def test_submesh(rng):
    mesh = pair_mesh(n_devices=4)
    assert mesh.devices.size == 4
    p1, p2 = _batch(rng, 32)
    p1s, p2s = shard_pairs(mesh, p1, p2)
    rs = gjkepa_batch_sharded(mesh, p1s, p2s)
    ru = gjkepa_batch(p1, p2)
    np.testing.assert_array_equal(np.asarray(rs.hit), np.asarray(ru.hit))


def test_sharded_f32_matches_unsharded(rng):
    """The float32 query under shard_map on the 8-virtual-device CPU mesh
    equals the unsharded float32 result."""
    cfg = GJKEPAConfig.for_f32()
    b, n = 64, 8
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    p1 = jnp.asarray(v + rng.normal(size=(b, 1, 3)) * 0.6, jnp.float32)
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    p2 = jnp.asarray(v + rng.normal(size=(b, 1, 3)) * 0.6, jnp.float32)

    mesh = pair_mesh(8)
    p1s, p2s = shard_pairs(mesh, p1, p2)
    rs = gjkepa_batch_sharded(mesh, p1s, p2s, cfg=cfg)
    ru = gjkepa_batch(p1, p2, cfg=cfg)
    np.testing.assert_array_equal(np.asarray(rs.hit), np.asarray(ru.hit))
    m = np.asarray(ru.hit)
    assert m.sum() > 3
    np.testing.assert_allclose(np.asarray(rs.depth)[m], np.asarray(ru.depth)[m],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(rs.contact_point)[m],
                               np.asarray(ru.contact_point)[m], atol=1e-5)
