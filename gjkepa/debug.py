"""Debug / sanitizer mode (SURVEY.md §5.2).

The reference achieves "debuggability" interactively: ``WRITE`` + ``PAUSE``
/ ``STOP`` on impossible states (``/root/reference/src/GCLIB_GJKEPA.f90:
300-302,337-339,499-501,1370-1372``) and thread safety by ``THREADPRIVATE``
construction.  Here queries are pure functions, so races are impossible by
construction; what remains worth sanitizing is *numerics*: NaN/Inf escaping
a query, which in f32 production mode would silently poison a whole batch.

:func:`checked_gjkepa_batch` wraps the portable XLA path with explicit
pre/postcondition checks compiled into one jitted program: finite inputs,
finite outputs, non-negative depth and unit normal on hit lanes.  On any
violation it raises :class:`DebugCheckError` naming the failed check and
the offending batch lanes.  This is the CI / debugging tier — production
code calls the unchecked paths.

:func:`checked_manifold_batch` / :func:`checked_manifold_shapes_batch`
wrap the manifold ops with a geometric postcondition: every valid manifold
point lies inside the contact-plane slab spanned by the two support planes
along the contact normal (widened by the reference's 0.1 support-set
clustering tolerance, ref :471-529).

Implementation note: ``jax.experimental.checkify`` was the planned
mechanism, but in this JAX version checkify cannot transform a
``lax.while_loop`` whose predicate depends on batched carry under ``vmap``
(the init-retry loop, ref :86: it raises ``ValueError: foreach() argument 2
is longer than argument 1`` deep in the while batching rule, with ANY error
set enabled).  Explicit boundary checks cover the same failure surface —
NaN/Inf ingress and egress plus output contracts — without depending on
checkify's per-primitive rewrite.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .api import gjkepa_batch
from .config import GJKEPAConfig
from .precision import highest_precision

__all__ = [
    "checked_gjkepa_batch",
    "checked_manifold_batch",
    "checked_manifold_shapes_batch",
    "DebugCheckError",
]


class DebugCheckError(ValueError):
    """A sanitizer check failed; message names the check and the lanes."""


@functools.partial(jax.jit, static_argnames=("cfg",))
@highest_precision
def _checked_jit(p1, p2, cfg):
    res = gjkepa_batch(p1, p2, cfg=cfg)
    fin = lambda x: jnp.all(jnp.isfinite(x), axis=tuple(range(1, x.ndim)))
    nrm2 = jnp.sum(res.normal * res.normal, axis=-1)
    # supported coordinate range of an f32 tolerance ladder: rounding noise
    # (~1e-7 * |x|) must stay well below eps_coincide; the config's scale
    # is eps_coincide / 1e-5 (see GJKEPAConfig.for_f32)
    if p1.dtype == jnp.float32:
        limit = 200.0 * (cfg.eps_coincide / 1e-5)
        in_range = (jnp.max(jnp.abs(p1), axis=(1, 2)) <= limit) \
            & (jnp.max(jnp.abs(p2), axis=(1, 2)) <= limit)
    else:
        in_range = jnp.ones((p1.shape[0],), bool)
    checks = {
        # precondition: a NaN/Inf vertex would otherwise poison its lane
        # silently in f32 production mode (argmax may even mask it away)
        "non-finite input vertex (NaN/Inf in p1 or p2)": fin(p1) & fin(p2),
        # precondition: coordinates beyond the f32 ladder's supported range
        # (pass GJKEPAConfig.for_f32(scale=...) for large scenes)
        "f32 coordinates exceed the tolerance ladder's supported range":
            in_range,
        # postconditions: the output contract of ref :65-71 (outputs zeroed
        # unless filled with converged values)
        "non-finite depth": fin(res.depth),
        "non-finite normal": fin(res.normal),
        "non-finite contact point": fin(res.contact_point),
        "non-finite nearest points": fin(res.nearest_points),
        "negative penetration depth on a hit lane":
            jnp.where(res.hit, res.depth, 0.0) >= 0.0,
        "non-unit contact normal on a hit lane":
            jnp.where(res.hit, jnp.abs(nrm2 - 1.0) < 1e-3, True),
    }
    return res, checks


def _raise_failed(checks):
    for name, ok in checks.items():
        ok = np.asarray(ok)
        if ok.ndim > 1:                      # per-lane AND of trailing dims
            ok = ok.reshape(ok.shape[0], -1).all(axis=1)
        if not ok.all():
            lanes = np.nonzero(~ok)[0]
            raise DebugCheckError(
                f"sanitizer check failed: {name} "
                f"(lanes {lanes[:16].tolist()}"
                f"{'…' if lanes.size > 16 else ''})")


@functools.partial(jax.jit, static_argnames=("cfg",))
@highest_precision
def _checked_manifold_hulls_jit(p1, p2, normal, depth, hit, contact_point,
                                cfg):
    from .ops.manifold import manifold_batch

    m = manifold_batch(p1, p2, normal, depth, hit, contact_point, cfg=cfg)
    lane_fin = lambda x: jnp.all(  # noqa: E731
        jnp.isfinite(x), axis=tuple(range(1, x.ndim)))
    # contact-plane slab: every valid manifold point must lie (along the
    # contact normal) between B's lowest support and A's highest support,
    # widened by the clustering tolerance — the support polygons feeding
    # the clip are by construction within tol of those planes
    # (ref :471-529's 0.1 support-set rule).
    s_a = jnp.max(jnp.einsum("bnk,bk->bn", p1, normal), axis=1)  # (B,)
    s_b = jnp.min(jnp.einsum("bnk,bk->bn", p2, normal), axis=1)
    z = jnp.einsum("bmk,bk->bm", m.points, normal)               # (B, 4)
    slack = cfg.support_set_tol + 1e-3
    in_slab = (z >= (jnp.minimum(s_b, s_a) - slack)[:, None]) \
        & (z <= (jnp.maximum(s_a, s_b) + slack)[:, None])
    checks = {
        "10: non-finite manifold point": lane_fin(m.points),
        "11: non-finite manifold depth": lane_fin(m.depths),
        "12: negative manifold point depth":
            jnp.all(jnp.where(m.mask, m.depths, 0.0) >= 0.0, axis=1),
        "13: manifold point on a miss lane":
            jnp.where(hit, True, ~jnp.any(m.mask, axis=1)),
        "14: manifold point off the contact plane slab":
            jnp.all(jnp.where(m.mask & hit[:, None], in_slab, True), axis=1),
    }
    return m, checks


def checked_manifold_batch(p1, p2, normal, depth, hit, contact_point,
                           cfg: GJKEPAConfig | None = None):
    """:func:`gjkepa.ops.manifold.manifold_batch` under the numerics
    sanitizer: finite outputs, per-point depth >= 0, no manifold points on
    miss lanes, and every valid point inside the contact-plane slab spanned
    by the two support planes along the normal."""
    cfg = cfg if cfg is not None else GJKEPAConfig.for_f32()
    m, checks = _checked_manifold_hulls_jit(p1, p2, normal, depth, hit,
                                            contact_point, cfg)
    _raise_failed(checks)
    return m


@functools.partial(jax.jit, static_argnames=("cfg",))
@highest_precision
def _checked_manifold_shapes_jit(a, b, normal, depth, hit, contact_point,
                                 cfg):
    from .ops.manifold import manifold_shapes_batch

    m = manifold_shapes_batch(a, b, normal, depth, hit, contact_point,
                              cfg=cfg)
    lane_fin = lambda x: jnp.all(  # noqa: E731
        jnp.isfinite(x), axis=tuple(range(1, x.ndim)))
    # analytic support along +-n per side via the closed-form support maps
    from .models.shapes import shape_support_world

    sup = jax.vmap(shape_support_world)
    s_a = jnp.einsum("bk,bk->b",
                     sup(a.kind, a.params, a.pos, a.rot, normal), normal)
    s_b = jnp.einsum("bk,bk->b",
                     sup(b.kind, b.params, b.pos, b.rot, -normal), normal)
    z = jnp.einsum("bmk,bk->bm", m.points, normal)
    slack = cfg.support_set_tol + 1e-3
    in_slab = (z >= (jnp.minimum(s_b, s_a) - slack)[:, None]) \
        & (z <= (jnp.maximum(s_a, s_b) + slack)[:, None])
    checks = {
        "10: non-finite manifold point": lane_fin(m.points),
        "11: non-finite manifold depth": lane_fin(m.depths),
        "12: negative manifold point depth":
            jnp.all(jnp.where(m.mask, m.depths, 0.0) >= 0.0, axis=1),
        "13: manifold point on a miss lane":
            jnp.where(hit, True, ~jnp.any(m.mask, axis=1)),
        "14: manifold point off the contact plane slab":
            jnp.all(jnp.where(m.mask & hit[:, None], in_slab, True), axis=1),
    }
    return m, checks


def checked_manifold_shapes_batch(a, b, normal, depth, hit, contact_point,
                                  cfg: GJKEPAConfig | None = None):
    """:func:`gjkepa.ops.manifold.manifold_shapes_batch` under the
    numerics sanitizer (see :func:`checked_manifold_batch`)."""
    cfg = cfg if cfg is not None else GJKEPAConfig.for_f32()
    m, checks = _checked_manifold_shapes_jit(a, b, normal, depth, hit,
                                             contact_point, cfg)
    _raise_failed(checks)
    return m


def checked_gjkepa_batch(p1, p2, cfg: GJKEPAConfig | None = None):
    """``gjkepa_batch`` under the numerics sanitizer.

    Raises :class:`DebugCheckError` if any input vertex is NaN/Inf, any
    output is non-finite, or a hit lane violates the depth/normal contract
    — reporting the failing check and batch lane indices; otherwise returns
    the same batched :class:`CollisionResult` as the unchecked path.
    """
    cfg = cfg if cfg is not None else GJKEPAConfig()
    res, checks = _checked_jit(p1, p2, cfg)
    _raise_failed(checks)
    return res
