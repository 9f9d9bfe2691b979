"""Large-hull scaling (SURVEY.md §5.7).

The reference takes arbitrary N1/N2 per call (`/root/reference/src/
GCLIB_GJKEPA.f90:43-46`); its support scan is a sequential O(N) loop
(:1040-1057).  Here the support is a masked argmax over the padded vertex
buffer, so large hulls need no special path.  These tests pin float32
agreement with float64 up to n1 + n2 = 8192 vertices per pair, first-max
tie-breaking under row repetition, and mask support at large N.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig, gjkepa_batch

F32 = GJKEPAConfig.for_f32()
F64 = GJKEPAConfig()


def _big_hulls(rng, b, n, radius=1.0, spread=0.5):
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= radius * (0.6 + 0.4 * rng.random((b, n, 1)))
    v += rng.normal(size=(b, 1, 3)) * spread
    return v.astype(np.float32)


def _f32_vs_f64(p1, p2):
    r32 = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2), cfg=F32)
    r64 = gjkepa_batch(jnp.asarray(p1, jnp.float64),
                       jnp.asarray(p2, jnp.float64), cfg=F64)
    hit = np.asarray(r64.hit)
    np.testing.assert_array_equal(np.asarray(r32.hit), hit)
    assert hit.any()
    np.testing.assert_allclose(np.asarray(r32.depth)[hit],
                               np.asarray(r64.depth)[hit], atol=5e-5)


def test_n1024_f32_matches_f64():
    """Full pipeline at N=1024 vertices/hull: hit/depth agree with the
    float64 path — no accuracy cliff at large N."""
    rng = np.random.default_rng(11)
    _f32_vs_f64(_big_hulls(rng, 8, 1024), _big_hulls(rng, 8, 1024))


@pytest.mark.parametrize("n1,n2", [(2304, 2304), (4096, 64), (4096, 4096)])
def test_large_n_f32_matches_f64(n1, n2):
    """n1 + n2 > 4096 at a small batch: the sizes a streamed support
    would serve, through the one support path."""
    rng = np.random.default_rng(n1 + n2)
    _f32_vs_f64(_big_hulls(rng, 4, n1), _big_hulls(rng, 4, n2, radius=0.8))


def test_repeated_rows_are_identity():
    """Padding a hull by repeating its rows changes no GJK/EPA answer: the
    support argmax keeps the first of equal maxima (the reference's
    strict-> scan, ref :1040-1046), so those fields are bit-identical.
    (The contact point is not among them: repeated rows enter the support
    sets it is built from.)"""
    rng = np.random.default_rng(5)
    b, n = 4, 1536
    p1, p2 = _big_hulls(rng, b, n), _big_hulls(rng, b, n)
    r = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2), cfg=F32)
    rr = gjkepa_batch(jnp.asarray(np.concatenate([p1, p1[:, :1024]], axis=1)),
                      jnp.asarray(np.concatenate([p2, p2[:, ::2]], axis=1)),
                      cfg=F32)
    assert np.asarray(r.hit).any()
    for name in ("hit", "status", "depth", "normal", "distance",
                 "gjk_iters", "epa_iters"):
        np.testing.assert_array_equal(np.asarray(getattr(rr, name)),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)


def test_n1024_masked_equals_unpadded():
    """A 700-vertex hull padded to 1024 rows under a mask gives the same
    answer as the unpadded 700-vertex call (large-N mask path)."""
    rng = np.random.default_rng(3)
    b, n_real, n_pad = 4, 700, 1024
    p1 = _big_hulls(rng, b, n_real)
    p2 = _big_hulls(rng, b, n_real)
    pad1 = np.concatenate(
        [p1, np.full((b, n_pad - n_real, 3), 7e3, np.float32)], axis=1)
    pad2 = np.concatenate(
        [p2, np.full((b, n_pad - n_real, 3), -7e3, np.float32)], axis=1)
    m = np.zeros((b, n_pad), bool)
    m[:, :n_real] = True
    rm = gjkepa_batch(jnp.asarray(pad1), jnp.asarray(pad2),
                      jnp.asarray(m), jnp.asarray(m), cfg=F32)
    ru = gjkepa_batch(jnp.asarray(p1), jnp.asarray(p2), cfg=F32)
    np.testing.assert_array_equal(np.asarray(rm.hit), np.asarray(ru.hit))
    np.testing.assert_allclose(np.asarray(rm.depth), np.asarray(ru.depth),
                               atol=1e-6)
