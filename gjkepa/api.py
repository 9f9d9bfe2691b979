"""L4 public query API.

The reference exposes exactly one public symbol — ``SUBROUTINE GJKEPA``
(``/root/reference/src/GCLIB_GJKEPA.f90:39-239``): version selector +
face-contact tolerance + two convex vertex clouds in; hit flag, contact
type, nearest points, contact normal, contact point, penetration depth out.

Here the same contract is a pure function over padded vertex buffers,
returning a :class:`CollisionResult` pytree (plus status / iteration /
miss-distance extensions).  ``gjkepa`` handles one pair; ``gjkepa_batch``
is its vmapped, jitted batch form — the data-parallel equivalent of the
reference's "one pair per OpenMP thread" batch mode (SURVEY.md §2.4).

Analytic shapes enter through :func:`collide_supports`, which runs the same
GJK/EPA cores over arbitrary support callables (closed-form sphere / box /
capsule / cylinder maps).

Every public entry point traces under HIGHEST matmul precision
(:mod:`gjkepa.precision`), so float32 contractions never drop to TF32
on the GPU.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from .config import DEFAULT_CONFIG, GJKEPAConfig
from .ops import broadphase, contact
from .ops.distance import gjk_distance
from .ops.epa import polish_support_descent, run_epa
from .ops.gjk import run_gjk
from .ops.support import make_hull_support
from .precision import highest_precision
from .types import CollisionResult, Status

__all__ = ["gjkepa", "gjkepa_batch", "collide_supports",
           "collide_shapes_batch", "collide_hull_shape_batch",
           "gjk_distance_batch", "gjk_distance_shapes_batch", "derive_contact"]


def derive_contact(p1, p2, epa_normal, cfg: GJKEPAConfig,
                   mask1=None, mask2=None):
    """Contact post-processing from the EPA normal (version dispatch,
    ref :329-343): nearest points, contact point, (possibly rewritten)
    normal, contact type."""
    npts = contact.nearest_points(p1, p2, epa_normal, mask1, mask2)
    if cfg.version == 1:
        cpoint = contact.collision_point_v1(p1, p2, epa_normal, cfg, mask1, mask2)
        normal = epa_normal
    elif cfg.version == 2:
        cpoint = contact.collision_point_v2(p1, p2, epa_normal, cfg, mask1, mask2)
        normal = epa_normal
    elif cfg.version == 3:
        cpoint, normal = contact.collision_point_v3(p1, p2, epa_normal, cfg,
                                                    mask1, mask2)
    else:
        raise ValueError(f"unknown contact-point version {cfg.version!r} "
                         "(reference supports 1, 2, 3; ref :329-340)")
    ctype = contact.collision_type(p1, p2, normal, cfg.face_contact_tol,
                                   mask1, mask2)
    return npts, cpoint, normal, ctype


def _zero_result_like(dtype) -> dict:
    z3 = jnp.zeros(3, dtype)
    return dict(nearest_points=jnp.zeros((2, 3), dtype), normal=z3,
                contact_point=z3, depth=jnp.zeros((), dtype))


@functools.partial(jax.jit, static_argnames=("cfg", "use_broadphase"))
@highest_precision
def gjkepa(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    mask1: jnp.ndarray | None = None,
    mask2: jnp.ndarray | None = None,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    use_broadphase: bool = True,
) -> CollisionResult:
    """Full narrow-phase query for one pair of convex vertex clouds.

    Args:
      p1, p2: (N1, 3) / (N2, 3) padded vertex buffers (any float dtype).
      mask1, mask2: optional (N,) validity masks for padded rows.
      cfg: static numerical contract; ``cfg.version`` picks the
        contact-point algorithm (1/2/3, ref :329-340) and ``cfg.face_contact_tol``
        is the reference's TOL_FF input.
      use_broadphase: apply the bounding-sphere reject (ref :76-77).

    Mirrors the reference's output zeroing on miss (:65-71).
    """
    dtype = p1.dtype
    support = make_hull_support(p1, p2, mask1, mask2)

    if use_broadphase:
        active = broadphase.sphere_envelope_overlap(p1, p2, mask1, mask2,
                                                    cfg.broadphase_tol)
    else:
        active = jnp.asarray(True)

    g = run_gjk(support, cfg, dtype=dtype, active=active)
    e = run_epa(support, g.simplex, g.hit, cfg)
    npts, cpoint, normal, ctype = derive_contact(p1, p2, e.normal, cfg,
                                                 mask1, mask2)

    hit = g.hit
    zeros = _zero_result_like(dtype)
    return CollisionResult(
        hit=hit,
        colli_type=jnp.where(hit, ctype, jnp.int32(0)),
        nearest_points=jnp.where(hit, npts, zeros["nearest_points"]),
        normal=jnp.where(hit, normal, zeros["normal"]),
        contact_point=jnp.where(hit, cpoint, zeros["contact_point"]),
        depth=jnp.where(hit, e.depth, zeros["depth"]),
        distance=g.sep_lb,
        status=jnp.where(hit, e.status, g.status),
        gjk_iters=g.iters,
        epa_iters=e.iters,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "use_broadphase", "chunk_size"))
@highest_precision
def gjkepa_batch(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    mask1: jnp.ndarray | None = None,
    mask2: jnp.ndarray | None = None,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    use_broadphase: bool = True,
    chunk_size: int | None = None,
) -> CollisionResult:
    """Batched narrow-phase: (B, N, 3) vertex buffers -> batched results.

    One fused XLA program; batched while-loop lanes retire as individual
    queries converge.  This is the drop-in equivalent of the reference's
    OMP-parallel batch calling pattern.

    `chunk_size` bounds the vmapped width: the batch is processed as a scan
    of chunk-wide programs.  Use it for very large batches — it caps the
    working set of the EPA polytope buffers (memory ~ chunk * F_cap) and
    keeps single-program compile times down, at the cost of one scan.
    """
    fn = functools.partial(gjkepa, cfg=cfg, use_broadphase=use_broadphase)
    if chunk_size is None:
        in_axes = (0, 0, None if mask1 is None else 0, None if mask2 is None else 0)
        return jax.vmap(fn, in_axes=in_axes)(p1, p2, mask1, mask2)
    return jax.lax.map(lambda args: fn(*args), (p1, p2, mask1, mask2),
                       batch_size=chunk_size)


@highest_precision
def collide_supports(
    support: Callable,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    dtype=jnp.float32,
    active: jnp.ndarray | bool = True,
    hint: jnp.ndarray | None = None,
) -> CollisionResult:
    """Narrow-phase over an arbitrary Minkowski support callable.

    This is the analytic-shape entry (closed-form sphere/box/capsule/cylinder
    support maps — a capability extension over the reference, which only
    handles vertex clouds).  Contact point falls back to the midpoint of the
    EPA witness points (no vertex sets exist to run the version-1/2/3 case
    trees on); contact type is 1 on hit.

    `hint` (optional (3,) vector, need not be unit): a second descent start
    for the depth polish, typically the center-to-center direction —
    the descent is local, and an iteration-capped EPA direction on a DEEP
    smooth contact can sit in the wrong basin (measured 1.11 vs 0.59 exact
    on hull-vs-sphere); the center line is a natural global candidate
    there.  The better of the two descents wins.
    """
    g = run_gjk(support, cfg, dtype=dtype, active=active)
    e = run_epa(support, g.simplex, g.hit, cfg)
    # Closed-form supports are exact, so the fixed-cost support-function
    # descent sharpens EPA's polyhedral depth/normal: converged f32 EPA
    # leaves ~1e-3*R on smooth surfaces, and iteration-capped deep smooth
    # contacts can be
    # arbitrarily wrong (measured -0.06 vs 0.59 exact on hull-vs-sphere).
    depth, normal = polish_support_descent(support, e.depth, e.normal, g.hit)
    if hint is not None:
        hnorm = jnp.linalg.norm(hint)
        hunit = hint / jnp.maximum(hnorm, 1e-20)
        d2, n2 = polish_support_descent(support, depth, hunit,
                                        g.hit & (hnorm > 1e-9))
        better = g.hit & (d2 < depth)
        depth = jnp.where(better, d2, depth)
        normal = jnp.where(better, n2, normal)
    ok = g.hit & (jnp.linalg.norm(normal) > 0.5)
    status = jnp.where(ok, jnp.int32(Status.HIT), e.status)
    s = support(normal)
    npts = jnp.stack([s.a, s.b])
    cpoint = 0.5 * (s.a + s.b)
    hit = g.hit
    zeros = _zero_result_like(dtype)
    return CollisionResult(
        hit=hit,
        colli_type=jnp.where(hit, jnp.int32(1), jnp.int32(0)),
        nearest_points=jnp.where(hit, npts, zeros["nearest_points"]),
        normal=jnp.where(hit, normal, zeros["normal"]),
        contact_point=jnp.where(hit, cpoint, zeros["contact_point"]),
        depth=jnp.where(hit, depth, zeros["depth"]),
        distance=g.sep_lb,
        status=jnp.where(hit, status, g.status),
        gjk_iters=g.iters,
        epa_iters=e.iters,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "chunk_size"))
@highest_precision
def collide_shapes_batch(a, b, cfg: GJKEPAConfig = DEFAULT_CONFIG,
                         chunk_size: int | None = None) -> CollisionResult:
    """Batched narrow-phase over analytic shape pairs.

    Pairs with a closed form (sphere/capsule pairs, sphere-box,
    sphere-cylinder, box-box; :mod:`gjkepa.ops.closed_forms`) get its
    exact hit, depth, normal, distance and status; the others keep the
    polished GJK/EPA answer.

    Args:
      a, b: :class:`gjkepa.models.ShapeBatch` of equal length B;
        pair i is (a[i], b[i]).
      chunk_size: optional vmap-width bound (see gjkepa_batch).
    """
    from .models.shapes import make_shape_pair_support  # deferred: models imports ops

    dtype = a.params.dtype

    def one(ka, pa, xa, ra, kb, pb, xb, rb):
        sup = make_shape_pair_support(ka, pa, xa, ra, kb, pb, xb, rb)
        return collide_supports(sup, cfg=cfg, dtype=dtype, hint=xb - xa)

    args = (a.kind, a.params, a.pos, a.rot, b.kind, b.params, b.pos, b.rot)
    if chunk_size is None:
        res = jax.vmap(one)(*args)
    else:
        res = jax.lax.map(lambda xs: one(*xs), args, batch_size=chunk_size)

    # Exact answers where a closed form exists: EPA's polyhedral
    # approximation carries ~1e-4*R depth error on smooth shapes.
    from .ops.closed_forms import closed_form_shape_pairs

    cf, cf_hit, cf_depth, cf_normal, cf_gap, cf_status = \
        closed_form_shape_pairs(a, b, cfg.broadphase_tol)
    hit = jnp.where(cf, cf_hit, res.hit)
    depth = jnp.where(cf, cf_depth, res.depth)
    normal = jnp.where(cf[:, None], cf_normal, res.normal)
    res = res._replace(
        hit=hit,
        distance=jnp.where(cf, jnp.maximum(cf_gap, 0.0), res.distance),
        status=jnp.where(cf, cf_status, res.status))

    # Full contact contract on shapes (ref :47-52, dispatch :329-343):
    # nearest points, version-dispatched contact point (and version 3's
    # normal rewrite), TOL_FF contact type — from the closed-form
    # support-set case trees (ops.contact_shapes), replacing the generic
    # witness-midpoint/type-1 fallback of collide_supports.
    from .ops.contact_shapes import derive_contact_shapes_batch

    npts, cpoint, normal, ctype = derive_contact_shapes_batch(a, b, normal,
                                                              cfg)
    hit = res.hit
    z = jnp.zeros((), dtype)
    return res._replace(
        colli_type=jnp.where(hit, ctype, jnp.int32(0)),
        nearest_points=jnp.where(hit[:, None, None], npts, z),
        normal=jnp.where(hit[:, None], normal, z),
        contact_point=jnp.where(hit[:, None], cpoint, z),
        depth=jnp.where(hit, depth, z),
    )


@functools.partial(jax.jit, static_argnames=("cfg", "chunk_size"))
@highest_precision
def gjk_distance_batch(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    mask1: jnp.ndarray | None = None,
    mask2: jnp.ndarray | None = None,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    chunk_size: int | None = None,
):
    """Batched closest-distance queries over hull pairs (bench config c2).

    Returns a :class:`gjkepa.ops.distance.DistanceResult` batch: exact
    separation distance + witness points for separated pairs, 0 for
    intersecting pairs.  Capability extension — the reference never reports
    distance on the miss path (SURVEY.md §3.2).
    """
    def one(a, b, ma, mb):
        return gjk_distance(make_hull_support(a, b, ma, mb), cfg, dtype=p1.dtype)

    if chunk_size is None:
        in_axes = (0, 0, None if mask1 is None else 0, None if mask2 is None else 0)
        return jax.vmap(one, in_axes=in_axes)(p1, p2, mask1, mask2)
    return jax.lax.map(lambda xs: one(*xs), (p1, p2, mask1, mask2),
                       batch_size=chunk_size)


@functools.partial(jax.jit, static_argnames=("cfg", "chunk_size"))
@highest_precision
def gjk_distance_shapes_batch(a, b, cfg: GJKEPAConfig = DEFAULT_CONFIG,
                              chunk_size: int | None = None):
    """Batched closest-distance queries over analytic shape pairs
    (:class:`gjkepa.models.ShapeBatch`): exact separation distance +
    witness points for separated pairs, 0 for intersecting pairs — the
    shapes twin of :func:`gjk_distance_batch`."""
    from .models.shapes import make_shape_pair_support  # deferred

    dtype = a.params.dtype

    def one(ka, pa, xa, ra, kb, pb, xb, rb):
        sup = make_shape_pair_support(ka, pa, xa, ra, kb, pb, xb, rb)
        return gjk_distance(sup, cfg, dtype=dtype)

    args = (a.kind, a.params, a.pos, a.rot, b.kind, b.params, b.pos, b.rot)
    if chunk_size is None:
        return jax.vmap(one)(*args)
    return jax.lax.map(lambda xs: one(*xs), args, batch_size=chunk_size)


@functools.partial(jax.jit, static_argnames=("cfg", "chunk_size"))
@highest_precision
def collide_hull_shape_batch(
    p1: jnp.ndarray,
    shapes,
    mask1: jnp.ndarray | None = None,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    chunk_size: int | None = None,
) -> CollisionResult:
    """Mixed batched narrow-phase: convex hull vs analytic shape per pair.

    Args:
      p1: (B, N, 3) padded hull vertex buffers (side A).
      shapes: :class:`gjkepa.models.ShapeBatch` of length B (side B).

    Capability extension: the reference handles vertex clouds only; this
    pairs a cloud with a closed-form support map in the same query.
    """
    from .models.shapes import shape_support_world  # deferred: models imports ops
    from .ops.support import SupportResult, hull_support_point

    dtype = p1.dtype

    def one(verts, m, k, prm, pos, rot):
        def support(d):
            a = hull_support_point(verts, d, m)
            b = shape_support_world(k, prm, pos, rot, -d)
            return SupportResult(a - b, a, b)

        centroid = (jnp.mean(verts, axis=0) if m is None
                    else jnp.sum(jnp.where(m[:, None], verts, 0.0), axis=0)
                    / jnp.maximum(jnp.sum(m), 1))
        return collide_supports(support, cfg=cfg, dtype=dtype,
                                hint=pos - centroid)

    args = (p1, mask1, shapes.kind, shapes.params, shapes.pos, shapes.rot)
    if chunk_size is None:
        in_axes = (0, None if mask1 is None else 0, 0, 0, 0, 0)
        return jax.vmap(one, in_axes=in_axes)(*args)
    return jax.lax.map(lambda xs: one(*xs), args, batch_size=chunk_size)
