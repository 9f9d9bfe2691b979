"""Differential tests: batch-row contact derivation (ops.contact_rows) vs
the vmapped per-pair path (api.derive_contact) — the two must agree
output-for-output on every lane, for all three contact-point versions,
with and without vertex masks, including degenerate support-set shapes
(vertex-vertex, edge-edge, edge-face, face-face, coincident sets)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig
from gjkepa.api import derive_contact
from gjkepa.ops.contact_rows import derive_contact_rows
from tests.conftest import cube, random_hull


def _vmapped(p1, p2, nrm, cfg, m1, m2):
    in_axes = (0, 0, 0, None if m1 is None else 0, None if m2 is None else 0)
    return jax.vmap(lambda a, b, n, x, y: derive_contact(a, b, n, cfg, x, y),
                    in_axes=in_axes)(p1, p2, nrm, m1, m2)


def _compare(p1, p2, nrm, cfg, m1=None, m2=None, atol=1e-12):
    ref = _vmapped(p1, p2, nrm, cfg, m1, m2)
    got = derive_contact_rows(p1, p2, nrm, cfg, m1, m2)
    names = ("nearest_points", "contact_point", "normal", "colli_type")
    for name, a, b in zip(names, got, ref):
        if name == "colli_type":
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=atol, err_msg=name)


def _fixture(rng, b=48, n=14):
    p1 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * 0.4)
                   for _ in range(b)])
    p2 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * 0.4)
                   for _ in range(b)])
    nrm = rng.normal(size=(b, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(nrm)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_random_hulls_all_versions(rng, version):
    cfg = GJKEPAConfig(version=version)
    p1, p2, nrm = _fixture(rng)
    _compare(p1, p2, nrm, cfg)


@pytest.mark.parametrize("version", [1, 2, 3])
def test_masked_lanes(rng, version):
    cfg = GJKEPAConfig(version=version)
    p1, p2, nrm = _fixture(rng, b=24, n=12)
    m1 = jnp.asarray(rng.random((24, 12)) > 0.25)
    m2 = jnp.asarray(rng.random((24, 12)) > 0.25)
    # every lane keeps at least one vertex
    m1 = m1.at[:, 0].set(True)
    m2 = m2.at[:, 0].set(True)
    _compare(p1, p2, nrm, cfg, m1, m2)


def test_degenerate_contact_configurations():
    """Axis-aligned cube pairs pushed along coordinate normals exercise
    every (n1, n2) branch of the version-2 case tree: face-face (n>=3 both
    sides), edge-face, edge-edge, vertex-face, vertex-vertex."""
    cfg = GJKEPAConfig(version=2)
    fixtures = []
    c = cube([0, 0, 0])
    # face-face: +x faces against -x faces
    fixtures.append((c, cube([0.9, 0, 0]), [1.0, 0, 0]))
    # edge-face: rotate one cube 45 deg about z -> its edge meets a face
    th = np.deg2rad(45)
    rz = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    fixtures.append((c, cube([0, 0, 0]) @ rz.T + [1.1, 0, 0], [1.0, 0, 0]))
    # edge-edge: both rotated, crossing edges
    ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                   [-np.sin(th), 0, np.cos(th)]])
    fixtures.append((c @ rz.T, c @ ry.T + [1.1, 0, 0], [1.0, 0, 0]))
    # vertex-face: corner-rotated cube against a flat face
    q = rz @ ry
    fixtures.append((c @ q.T, cube([1.2, 0, 0]), [1.0, 0, 0]))
    # vertex-vertex: two corner-on cubes
    fixtures.append((c @ q.T, c @ q.T + [1.4, 0, 0], [1.0, 0, 0]))
    # diagonal normal (ties in support sets)
    d = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    fixtures.append((c, cube([0.5, 0.5, 0.5]), d))
    # coincident support set (all vertices of a tiny degenerate cloud)
    tiny = np.full((8, 3), 0.25)
    fixtures.append((tiny, c, [0, 0, 1.0]))

    b = len(fixtures)
    n = 8
    p1 = jnp.asarray(np.stack([f[0] for f in fixtures]))
    p2 = jnp.asarray(np.stack([f[1] for f in fixtures]))
    nrm = jnp.asarray(np.stack([np.asarray(f[2], float) for f in fixtures]))
    _compare(p1, p2, nrm, cfg)


def test_version3_rewrites_normal(rng):
    cfg = GJKEPAConfig(version=3)
    p1, p2, _ = _fixture(rng, b=16)
    nrm = jnp.asarray(np.tile([0.6, 0.0, 0.8], (16, 1)))
    _, _, out_n, _ = derive_contact_rows(p1, p2, nrm, cfg, None, None)
    out_n = np.asarray(out_n)
    np.testing.assert_allclose(out_n[:, 2], 0.0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(out_n, axis=1), 1.0, atol=1e-9)
