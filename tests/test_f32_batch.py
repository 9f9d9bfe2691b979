"""The float32 batch path — the precision the GPU runs — against the
float64 engine (x64 is on in the CPU tier) and the float64 oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig, gjkepa_batch
from tests.conftest import cube, random_hull
from tests.oracle_np import gjkepa_oracle

CFG = GJKEPAConfig.for_f32()
F64 = GJKEPAConfig()


def _batch(rng, b, n, spread=0.8):
    p1 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * spread)
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([random_hull(rng, n, center=rng.normal(size=3) * spread)
                   for _ in range(b)]).astype(np.float32)
    return p1, p2


def _both(p1, p2, cfg32=CFG, cfg64=F64, m1=None, m2=None):
    """(f32 result, f64 result) of the same float32-rounded geometry."""
    j = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
    r32 = gjkepa_batch(jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32),
                       j(m1), j(m2), cfg=cfg32)
    r64 = gjkepa_batch(jnp.asarray(p1, jnp.float64), jnp.asarray(p2, jnp.float64),
                       j(m1), j(m2), cfg=cfg64)
    return r32, r64


def _assert_agree(r32, r64, min_hits, depth_tol=2e-5):
    """Hit verdicts equal; depth within the f32 bound on lanes whose EPA
    normals agree (the same min face), and those are the large majority."""
    h32, h64 = np.asarray(r32.hit), np.asarray(r64.hit)
    np.testing.assert_array_equal(h32, h64)
    assert h64.sum() >= min_hits
    n32, n64 = np.asarray(r32.normal), np.asarray(r64.normal)
    same = h64 & (np.einsum("ij,ij->i", n32, n64) > 1.0 - 1e-4)
    assert same.sum() >= 0.9 * h64.sum()
    np.testing.assert_allclose(np.asarray(r32.depth)[same],
                               np.asarray(r64.depth)[same], atol=depth_tol)
    return same


def test_f32_matches_f64_path(rng):
    p1, p2 = _batch(rng, 128, 12)
    r32, r64 = _both(p1, p2)
    _assert_agree(r32, r64, min_hits=10)
    miss = ~np.asarray(r64.hit)
    np.testing.assert_array_equal(np.asarray(r32.status)[miss] != 0,
                                  np.asarray(r64.status)[miss] != 0)


def test_f32_known_geometry():
    c0 = cube([0, 0, 0]).astype(np.float32)
    offsets = [0.3, 0.7, 1.2, 2.5] * 32
    p1 = jnp.asarray(np.stack([c0] * 128))
    p2 = jnp.asarray(np.stack([c0 + np.array([dx, 0, 0], np.float32)
                               for dx in offsets]))
    r = gjkepa_batch(p1, p2, cfg=CFG)
    hit = np.asarray(r.hit)
    depth = np.asarray(r.depth)
    for i, dx in enumerate(offsets):
        if dx < 1.0:
            assert hit[i] and abs(depth[i] - (1.0 - dx)) < 1e-5, (i, dx, depth[i])
        else:
            assert not hit[i], (i, dx)


@pytest.mark.parametrize("chunk", [32, 48])
def test_chunked_batch_equals_vmapped(rng, chunk):
    """`chunk_size` (a scan of chunk-wide programs, with a remainder chunk
    when it does not divide the batch) returns the vmapped answer."""
    p1, p2 = (jnp.asarray(x) for x in _batch(rng, 100, 12))
    rv = gjkepa_batch(p1, p2, cfg=CFG)
    rc = gjkepa_batch(p1, p2, cfg=CFG, chunk_size=chunk)
    assert rc.hit.shape == (100,)
    for name in ("hit", "status", "depth", "normal", "contact_point"):
        np.testing.assert_allclose(np.asarray(getattr(rc, name)),
                                   np.asarray(getattr(rv, name)),
                                   atol=1e-6, err_msg=name)


def test_f32_ragged_hull_masks(rng):
    """Per-vertex masks in f32 agree with the masked f64 path (the
    reference takes arbitrary N1/N2 per call)."""
    b, n = 128, 16
    p1, p2 = _batch(rng, b, n)
    n1 = rng.integers(4, n + 1, size=b)
    n2 = rng.integers(4, n + 1, size=b)
    m1 = np.arange(n)[None, :] < n1[:, None]
    m2 = np.arange(n)[None, :] < n2[:, None]
    r32, r64 = _both(p1, p2, m1=m1, m2=m2)
    _assert_agree(r32, r64, min_hits=5)


def test_f32_full_contact_matches_f64(rng):
    p1, p2 = _batch(rng, 128, 12, spread=0.6)
    r32, r64 = _both(p1, p2)
    same = _assert_agree(r32, r64, min_hits=10)
    np.testing.assert_allclose(np.asarray(r32.contact_point)[same],
                               np.asarray(r64.contact_point)[same], atol=1e-4)
    agree_type = (np.asarray(r32.colli_type)[same]
                  == np.asarray(r64.colli_type)[same])
    assert agree_type.mean() > 0.95


def test_f32_deep_penetration_capacity():
    """Deep-penetration pairs fill the f32 EPA caps (F=80, V=40): depth
    still matches the float64 oracle."""
    rng = np.random.default_rng(3)
    b, n = 64, 24
    big = rng.normal(size=(b, n, 3))
    big /= np.linalg.norm(big, axis=-1, keepdims=True)
    big = (big * 2.0).astype(np.float32)
    small = rng.normal(size=(b, n, 3))
    small /= np.linalg.norm(small, axis=-1, keepdims=True)
    small = (small * 0.5 + rng.normal(size=(b, 1, 3)) * 0.2).astype(np.float32)
    r = gjkepa_batch(jnp.asarray(big), jnp.asarray(small), cfg=CFG)
    hit = np.asarray(r.hit)
    assert hit.mean() > 0.9  # deep-penetration fixture: nearly all hit
    checked = 0
    for i in np.nonzero(hit)[0][:16]:
        o = gjkepa_oracle(big[i].astype(np.float64), small[i].astype(np.float64))
        assert o.hit
        if not o.epa_capped:
            assert abs(float(r.depth[i]) - o.depth) < 2e-5, (i, o.depth)
            checked += 1
    assert checked >= 8


def test_f32_distance_matches_f64(rng):
    from gjkepa.api import gjk_distance_batch

    p1, p2 = _batch(rng, 128, 12, spread=2.0)
    r32 = gjk_distance_batch(jnp.asarray(p1), jnp.asarray(p2), cfg=CFG)
    r64 = gjk_distance_batch(jnp.asarray(p1, jnp.float64),
                             jnp.asarray(p2, jnp.float64), cfg=F64)
    np.testing.assert_array_equal(np.asarray(r32.intersecting),
                                  np.asarray(r64.intersecting))
    m = ~np.asarray(r32.intersecting)
    assert m.sum() > 50
    np.testing.assert_allclose(np.asarray(r32.distance)[m],
                               np.asarray(r64.distance)[m], atol=2e-5)
    # witnesses realize the distance
    gap = np.linalg.norm(np.asarray(r32.point_a) - np.asarray(r32.point_b), axis=1)
    np.testing.assert_allclose(gap[m], np.asarray(r32.distance)[m], atol=2e-5)


def test_collide_shapes_equals_closed_forms(rng):
    """``collide_shapes_batch`` returns the closed form's hit, depth,
    normal and status on every lane the closed forms handle."""
    from gjkepa import collide_shapes_batch
    from gjkepa.models.shapes import (boxes, capsules, concat_shapes,
                                      cylinders, spheres)
    from gjkepa.ops.closed_forms import closed_form_shape_pairs

    n = 64

    def rots(k):
        ms = []
        for _ in range(k):
            q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            if np.linalg.det(q) < 0:
                q[:, 0] *= -1
            ms.append(q)
        return jnp.asarray(np.stack(ms), jnp.float32)

    pos = lambda: jnp.asarray(  # noqa: E731
        rng.normal(size=(n, 3)).astype(np.float32) * 0.8)
    r = lambda: jnp.asarray(  # noqa: E731
        (0.3 + 0.4 * rng.random(n)).astype(np.float32))
    hext = lambda: jnp.asarray(  # noqa: E731
        0.2 + 0.4 * rng.random((n, 3)), jnp.float32)
    a = concat_shapes(
        spheres(r(), pos=pos()),
        capsules(r(), r(), pos=pos(), rot=rots(n)),
        spheres(r(), pos=pos()),
        spheres(r(), pos=pos()),
        cylinders(r(), r(), pos=pos(), rot=rots(n)),
        boxes(hext(), pos=pos(), rot=rots(n)),
        cylinders(r(), r(), pos=pos(), rot=rots(n)),
    )
    b = concat_shapes(
        capsules(r(), r(), pos=pos(), rot=rots(n)),
        capsules(r(), r(), pos=pos(), rot=rots(n)),
        boxes(hext(), pos=pos(), rot=rots(n)),
        cylinders(r(), r(), pos=pos(), rot=rots(n)),
        spheres(r(), pos=pos()),
        boxes(hext(), pos=pos(), rot=rots(n)),
        boxes(hext(), pos=pos(), rot=rots(n)),     # no closed form
    )
    res = collide_shapes_batch(a, b, cfg=CFG)
    handled, c_hit, c_depth, c_normal, _, c_status = (
        np.asarray(x) for x in closed_form_shape_pairs(a, b, CFG.broadphase_tol))
    assert handled[:6 * n].all() and not handled[6 * n:].any()
    h = handled
    np.testing.assert_array_equal(np.asarray(res.hit)[h], c_hit[h])
    np.testing.assert_array_equal(np.asarray(res.status)[h], c_status[h])
    # one-ulp slack: inside jit XLA fuses the closed forms differently
    np.testing.assert_allclose(np.asarray(res.depth)[h], c_depth[h], atol=2e-6)
    np.testing.assert_allclose(np.asarray(res.normal)[h], c_normal[h],
                               atol=2e-6)
    assert c_hit[h].sum() > 50


@pytest.mark.parametrize("version", [1, 3])
def test_f32_contact_versions(rng, version):
    """Contact-point versions 1 and 3 in f32 (version 2 is covered by
    test_f32_full_contact_matches_f64): contact point / type match the f64
    path, including version 3's normal rewrite (ref :334-335, :426-452)."""
    cfg32 = CFG.replace(version=version)
    cfg64 = F64.replace(version=version)
    b = 32
    p1 = np.stack([random_hull(rng, 10, center=rng.normal(size=3) * 0.4)
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([random_hull(rng, 10, center=rng.normal(size=3) * 0.4)
                   for _ in range(b)]).astype(np.float32)
    r32, r64 = _both(p1, p2, cfg32, cfg64)
    hit = np.asarray(r64.hit)
    np.testing.assert_array_equal(np.asarray(r32.hit), hit)
    assert hit.sum() >= 4
    # contact outputs are functions of the EPA normal; compare only lanes
    # where both precisions found the same normal
    nf, nx = np.asarray(r32.normal), np.asarray(r64.normal)
    agree = hit & (np.einsum("ij,ij->i", nf, nx) > 1.0 - 1e-5)
    assert agree.sum() >= hit.sum() * 3 // 4
    np.testing.assert_array_equal(np.asarray(r32.colli_type)[agree],
                                  np.asarray(r64.colli_type)[agree])
    np.testing.assert_allclose(np.asarray(r32.contact_point)[agree],
                               np.asarray(r64.contact_point)[agree],
                               atol=1e-4)
    if version == 3:  # the rewritten normal lies in the XY plane
        np.testing.assert_allclose(nf[hit][:, 2], 0.0, atol=1e-6)
