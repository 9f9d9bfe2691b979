"""Scale-awareness of the f32 tolerance ladder.

The reference's epsilon ladder is absolute (SURVEY.md §2.2); the f32 perf
mode rescales it, which only works while coordinates stay O(1-100).  These
tests pin (a) large-coordinate correctness under ``for_f32(scale=...)``,
(b) the sanitizer rejecting out-of-range coordinates under the default
ladder, and (c) translation invariance of hit/depth at large offsets.
"""

import numpy as np
import jax.numpy as jnp

import pytest

from gjkepa import GJKEPAConfig, gjkepa_batch
from gjkepa.debug import DebugCheckError, checked_gjkepa_batch
from tests.conftest import cube, random_hull


def test_large_coordinate_differential_vs_f64(rng):
    """Hull pairs around |x| ~ 1e3 with for_f32(scale=10): hit verdicts
    match the f64 reference ladder; depth within the f32 cancellation
    budget (~1e-7 * |x|)."""
    b = 48
    far = np.array([1000.0, -750.0, 500.0])
    p1 = np.stack([random_hull(rng, 12, center=far + rng.normal(size=3) * 0.8)
                   for _ in range(b)])
    p2 = np.stack([random_hull(rng, 12, center=far + rng.normal(size=3) * 0.8)
                   for _ in range(b)])
    r64 = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2), cfg=GJKEPAConfig())
    cfg32 = GJKEPAConfig.for_f32(scale=10.0)
    r32 = gjkepa_batch(jnp.asarray(p1, dtype=jnp.float32),
                       jnp.asarray(p2, dtype=jnp.float32), cfg=cfg32)
    h64, h32 = np.asarray(r64.hit), np.asarray(r32.hit)
    # classification at 1e3 coordinates: allow no more than one marginal
    # flip in 48 lanes (f32 input rounding legitimately moves ~1e-4-deep
    # contacts across the boundary)
    assert (h64 != h32).sum() <= 1, np.nonzero(h64 != h32)
    m = h64 & h32
    assert m.sum() >= 5
    np.testing.assert_allclose(np.asarray(r32.depth)[m],
                               np.asarray(r64.depth)[m], atol=5e-4)


def test_translation_invariance_at_large_offset(rng):
    """The same pair evaluated at the origin and at +1e3 must agree
    (scale-aware ladder): hit identical, depth within f32 cancellation."""
    b = 32
    p1 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 0.6)
                   for _ in range(b)]).astype(np.float32)
    p2 = np.stack([random_hull(rng, 12, center=rng.normal(size=3) * 0.6)
                   for _ in range(b)]).astype(np.float32)
    off = np.array([1000.0, 1000.0, 1000.0], np.float32)
    cfg32 = GJKEPAConfig.for_f32(scale=10.0)
    r0 = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2), cfg=cfg32)
    r1 = gjkepa_batch(jnp.asarray(p1 + off), jnp.asarray(p2 + off), cfg=cfg32)
    h0, h1 = np.asarray(r0.hit), np.asarray(r1.hit)
    assert (h0 != h1).sum() <= 1
    m = h0 & h1
    assert m.sum() >= 5
    np.testing.assert_allclose(np.asarray(r1.depth)[m],
                               np.asarray(r0.depth)[m], atol=5e-4)


def test_sanitizer_rejects_out_of_range_f32_coordinates():
    """Default for_f32() ladder + |x| ~ 1e3 coordinates = out of contract:
    the sanitizer must name the range check instead of silently degrading."""
    c = cube([1000.0, 0.0, 0.0]).astype(np.float32)
    with pytest.raises(DebugCheckError, match="supported range"):
        checked_gjkepa_batch(jnp.asarray(c[None]), jnp.asarray(c[None]),
                             cfg=GJKEPAConfig.for_f32())


def test_sanitizer_accepts_scaled_ladder():
    c = cube([1000.0, 0.0, 0.0]).astype(np.float32)
    res = checked_gjkepa_batch(jnp.asarray(c[None]), jnp.asarray(c[None]),
                               cfg=GJKEPAConfig.for_f32(scale=10.0))
    assert bool(res.hit[0])


def test_identical_geometry_f32_jit_hits():
    """Identical coincident shapes must HIT under f32 + jit.

    Regression: with the origin exactly on the s1-s2 init segment
    (symmetric Minkowski difference), compiled-XLA FMA contraction left
    vec_pl's foot a few ulps off zero; normalizing that noise produced an
    init direction whose support coincided with s2 and the query
    misclassified as MISS_INIT (status 1) — under jit only, eager f32 was
    fine.  The init phase now treats sub-eps_coincide rejections as
    on-line and takes the perpendicular fallback (ops/gjk.py)."""
    from gjkepa.types import Status

    c = cube([0.0, 0.0, 0.0]).astype(np.float32)
    for cfg in (GJKEPAConfig(), GJKEPAConfig.for_f32()):
        r = gjkepa_batch(jnp.asarray(c[None]), jnp.asarray(c[None]), cfg=cfg)
        assert bool(r.hit[0]), int(r.status[0])
        assert int(r.status[0]) == Status.HIT
        assert float(r.depth[0]) == pytest.approx(1.0, abs=1e-5)
    # the same lane inside a wider f32 batch
    rb = gjkepa_batch(jnp.asarray(np.repeat(c[None], 8, 0)),
                      jnp.asarray(np.repeat(c[None], 8, 0)),
                      cfg=GJKEPAConfig.for_f32())
    assert np.asarray(rb.hit).all()
    np.testing.assert_allclose(np.asarray(rb.depth), 1.0, atol=1e-5)
