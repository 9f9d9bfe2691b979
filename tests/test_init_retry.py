"""The init-retry ladder (ref :86-89) in float32 and float64.

GJK's init phase retries deterministic directions until v1 = support(d)
and v2 = support(-d) differ, up to 99 times.  Only a Minkowski difference
that is (within the coincidence tolerance) a single point exhausts it:

**Claim.**  If v1 and v2 coincide for the first 8 table directions, they
coincide for ALL directions, so the pair is classified MISS_INIT.

**Proof.**  v1 maximizes <d, .> over the difference cloud and v2 minimizes
it, so ``v1 == v2`` forces the cloud's extent along d to zero.  Exact
coincidence along 8 directions whose span is all of R^3 bounds the cloud's
DIAMETER by 0.  With the reference's 1e-8 coincidence tolerance,
``diam <= sqrt(3) * tol_8 / sigma_min`` where ``sigma_min`` is the
smallest singular value of the 8x3 direction matrix; ``test_first8_span_r3``
certifies it is O(1), so divergence between precisions or retry budgets is
confined to a shell of width ~1e-8 around exact degeneracy.
"""

import jax.numpy as jnp
import numpy as np

from gjkepa import GJKEPAConfig, Status, gjkepa_batch
from gjkepa.ops.directions import DIRECTION_TABLE

F32 = GJKEPAConfig.for_f32()


def test_first8_span_r3():
    """sigma_min of the first 8 direction rows is O(1): they span R^3
    with margin, which is what makes 8 retries as decisive as 99 (see
    module docstring)."""
    d8 = np.asarray(DIRECTION_TABLE[:8], np.float64)
    assert d8.shape == (8, 3)
    sigma = np.linalg.svd(d8, compute_uv=False)
    assert sigma[-1] > 0.8, sigma  # measured ~1.17; any O(1) bound suffices
    # => diameter of a cloud flat (tol 1e-8) along all 8 dirs is
    #    <= sqrt(3)*1e-8/sigma_min < 2.2e-8: below coincidence scale in any
    #    direction, so retries 9..99 cannot produce a distinct support.


def _point_cloud_pair(offset):
    """Hull buffers whose Minkowski difference is a SINGLE POINT (every
    vertex row identical): the only inputs that can exhaust init retries."""
    a = np.full((1, 8, 3), 0.0, np.float32) + np.array([0.2, -0.1, 0.3],
                                                       np.float32)
    b = a + np.asarray(offset, np.float32)
    return jnp.asarray(a), jnp.asarray(b)


def test_point_pair_both_precisions_miss_init():
    """Degenerate single-point difference: float64 and float32 must both
    give up with MISS_INIT and no hit."""
    a, b = _point_cloud_pair([0.05, 0.0, 0.0])  # nearby -> passes broadphase
    rx = gjkepa_batch(a.astype(jnp.float64), b.astype(jnp.float64),
                      cfg=GJKEPAConfig())
    rf = gjkepa_batch(a, b, cfg=F32)
    assert not bool(rx.hit[0]) and not bool(rf.hit[0])
    assert int(rx.status[0]) == Status.MISS_INIT, int(rx.status[0])
    assert int(rf.status[0]) == Status.MISS_INIT, int(rf.status[0])


def test_coincident_point_pair_both_precisions_agree():
    """Exactly coincident point clouds (difference == origin): whatever the
    reference semantics produce in float64, float32 must match verdict and
    status."""
    a, b = _point_cloud_pair([0.0, 0.0, 0.0])
    rx = gjkepa_batch(a.astype(jnp.float64), b.astype(jnp.float64),
                      cfg=GJKEPAConfig())
    rf = gjkepa_batch(a, b, cfg=F32)
    assert bool(rx.hit[0]) == bool(rf.hit[0])
    assert int(rx.status[0]) == int(rf.status[0])


def test_flat_segment_pairs_agree(rng):
    """Near-degenerate (collinear / coplanar) clouds stress the retry
    ladder without fully exhausting it: float32 must classify every one
    exactly like float64."""
    b = 32
    t = rng.random((b, 8, 1))
    axis = rng.normal(size=(b, 1, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    seg1 = (t - 0.5) * axis                      # collinear clouds
    seg2 = (rng.random((b, 8, 1)) - 0.5) * axis + rng.normal(size=(b, 1, 3)) * 0.05
    a1 = jnp.asarray(seg1, jnp.float32)
    a2 = jnp.asarray(seg2, jnp.float32)
    rx = gjkepa_batch(a1.astype(jnp.float64), a2.astype(jnp.float64),
                      cfg=GJKEPAConfig())
    rf = gjkepa_batch(a1, a2, cfg=F32)
    np.testing.assert_array_equal(np.asarray(rx.hit), np.asarray(rf.hit))
