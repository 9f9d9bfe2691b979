"""Sanitizer / debug mode (SURVEY.md §5.2): checkify NaN + OOB + contract
checks around the portable query path."""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig, gjkepa_batch
from gjkepa.debug import checked_gjkepa_batch
from tests.conftest import cube, random_hull


def _batch(rng, b=8):
    p1 = np.stack([random_hull(rng, 10, center=rng.normal(size=3) * 0.5)
                   for _ in range(b)])
    p2 = np.stack([random_hull(rng, 10, center=rng.normal(size=3) * 0.5)
                   for _ in range(b)])
    return jnp.asarray(p1), jnp.asarray(p2)


@pytest.mark.slow
def test_clean_inputs_pass_and_match_unchecked(rng):
    p1, p2 = _batch(rng)
    cfg = GJKEPAConfig()
    r = checked_gjkepa_batch(p1, p2, cfg=cfg)   # must not raise
    ru = gjkepa_batch(p1, p2, cfg=cfg)
    np.testing.assert_array_equal(np.asarray(r.hit), np.asarray(ru.hit))
    np.testing.assert_array_equal(np.asarray(r.depth), np.asarray(ru.depth))


def test_nan_input_raises(rng):
    p1, p2 = _batch(rng)
    p1 = p1.at[3, 2, 1].set(jnp.nan)
    with pytest.raises(Exception, match="nan|NaN|non-finite"):
        checked_gjkepa_batch(p1, p2, cfg=GJKEPAConfig())


@pytest.mark.slow
def test_inf_input_raises():
    p1 = jnp.asarray(np.stack([cube(), cube()]))
    p2 = jnp.asarray(np.stack([cube([0.5, 0, 0]), cube([0.25, 0, 0])]))
    p2 = p2.at[1, 0, 0].set(jnp.inf)
    with pytest.raises(Exception):
        checked_gjkepa_batch(p1, p2, cfg=GJKEPAConfig())


@pytest.mark.slow
def test_checked_manifold_clean_and_poisoned(rng):
    from gjkepa import gjkepa_batch
    from gjkepa.debug import DebugCheckError, checked_manifold_batch

    cfg = GJKEPAConfig()
    # overlapping cubes: face-face manifolds
    p1 = jnp.asarray(np.stack([cube(), cube([0.2, 0, 0])]))
    p2 = jnp.asarray(np.stack([cube([0.3, 0, 0]), cube([0.4, 0.1, 0])]))
    r = gjkepa_batch(p1, p2, cfg=cfg)
    m = checked_manifold_batch(p1, p2, r.normal, r.depth, r.hit,
                               r.contact_point, cfg=cfg)   # must not raise
    assert bool(jnp.any(m.mask))
    # poison the narrow-phase normal: NaN must be caught at the manifold
    bad_n = r.normal.at[0, 0].set(jnp.nan)
    with pytest.raises(DebugCheckError, match="non-finite"):
        checked_manifold_batch(p1, p2, bad_n, r.depth, r.hit,
                               r.contact_point, cfg=cfg)


def test_checked_manifold_slab_violation():
    """Vertex-vertex contact (support sets of 1 vertex each) forces the
    degenerate fallback, whose single manifold point is the caller's
    contact_point verbatim — a poisoned contact point far outside the
    support slab must trip the contact-plane check."""
    from gjkepa.debug import DebugCheckError, checked_manifold_batch

    cfg = GJKEPAConfig()
    # tetra A apex at +x, tetra B apex at -x, apexes interpenetrating 0.1
    tet_a = np.array([[0.5, 0, 0], [-0.5, 0.4, 0], [-0.5, -0.4, 0.4],
                      [-0.5, -0.4, -0.4]])
    tet_b = -tet_a + np.array([0.9, 0.0, 0.0])
    p1 = jnp.asarray(tet_a[None])
    p2 = jnp.asarray(tet_b[None])
    n = jnp.asarray(np.array([[1.0, 0.0, 0.0]]))
    depth = jnp.asarray([0.1])
    hit = jnp.asarray([True])
    good_pt = jnp.asarray(np.array([[0.45, 0.0, 0.0]]))
    m = checked_manifold_batch(p1, p2, n, depth, hit, good_pt, cfg=cfg)
    assert bool(m.mask[0, 0])
    far_pt = jnp.asarray(np.array([[100.0, 0.0, 0.0]]))
    with pytest.raises(DebugCheckError, match="contact plane slab"):
        checked_manifold_batch(p1, p2, n, depth, hit, far_pt, cfg=cfg)


@pytest.mark.slow
def test_checked_manifold_shapes_clean_and_poisoned(rng):
    from gjkepa import collide_shapes_batch
    from gjkepa.debug import (DebugCheckError,
                                  checked_manifold_shapes_batch)
    from gjkepa.models import boxes

    cfg = GJKEPAConfig.for_f32()
    h = jnp.asarray(np.full((4, 3), 0.5, np.float32))
    a = boxes(h, pos=jnp.zeros((4, 3), jnp.float32))
    b = boxes(h, pos=jnp.asarray(
        np.array([[0.3, 0, 0], [0, 0.4, 0], [0, 0, 0.5], [3.0, 0, 0]],
                 np.float32)))
    r = collide_shapes_batch(a, b, cfg=cfg)
    m = checked_manifold_shapes_batch(a, b, r.normal, r.depth, r.hit,
                                      r.contact_point, cfg=cfg)
    assert bool(jnp.any(m.mask))
    bad_n = r.normal.at[1, 1].set(jnp.nan)
    with pytest.raises(DebugCheckError, match="non-finite"):
        checked_manifold_shapes_batch(a, b, bad_n, r.depth, r.hit,
                                      r.contact_point, cfg=cfg)
