"""L2 support maps over the Minkowski difference.

The reference's hot primitive is ``support_mapping`` — two argmax-dot linear
scans over the raw vertex arrays, called from 7 sites
(``/root/reference/src/GCLIB_GJKEPA.f90:1030-1062``, SURVEY.md C5).  Here it
becomes a masked argmax over padded vertex buffers (ties resolve to the
first index, exactly like the Fortran strict-``>`` scan), plus closed-form
analytic supports for sphere/box/capsule/cylinder — the capability extension
bench config c3 exercises.

All functions take a single query's data and are vmapped by callers; under
vmap the dot products become one batched contraction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

__all__ = [
    "hull_support_point",
    "minkowski_support_hulls",
    "make_hull_support",
    "sphere_support",
    "box_support",
    "capsule_support",
    "cylinder_support",
    "SupportResult",
]


class SupportResult(NamedTuple):
    """Support of the Minkowski difference A - B along `dir`."""

    w: jnp.ndarray   # (3,) support point of A - B
    a: jnp.ndarray   # (3,) witness on A  (argmax <dir, a>)
    b: jnp.ndarray   # (3,) witness on B  (argmax <-dir, b>)


def hull_support_point(verts: jnp.ndarray, d: jnp.ndarray,
                       mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """argmax_{v in verts} <d, v> over a padded vertex buffer.

    First index wins ties, matching the Fortran strict-> scan (ref :1040-1046).
    The winning row is extracted with a first-max one-hot contraction rather
    than a gather; under HIGHEST precision (every public entry point) the
    copy is exact.  Whether a gather is faster on the GPU is open (ROADMAP
    queue 3).
    """
    dots = verts @ d
    if mask is not None:
        dots = jnp.where(mask, dots, -jnp.inf)
    i = jnp.argmax(dots)  # first max, like the Fortran strict-> scan
    onehot = (jnp.arange(verts.shape[0]) == i).astype(verts.dtype)
    return onehot @ verts


def minkowski_support_hulls(p1: jnp.ndarray, p2: jnp.ndarray, d: jnp.ndarray,
                            mask1: jnp.ndarray | None = None,
                            mask2: jnp.ndarray | None = None) -> SupportResult:
    """support_mapping(p1, p2, dir) = argmax<d,p1> - argmax<-d,p2> (ref :1030-1062)."""
    a = hull_support_point(p1, d, mask1)
    b = hull_support_point(p2, -d, mask2)
    return SupportResult(a - b, a, b)


def make_hull_support(p1, p2, mask1=None, mask2=None) -> Callable[[jnp.ndarray], SupportResult]:
    """Close over padded vertex buffers; the GJK/EPA cores are generic over
    this callable so analytic shapes slot in transparently."""

    def support(d: jnp.ndarray) -> SupportResult:
        return minkowski_support_hulls(p1, p2, d, mask1, mask2)

    return support


# ---------------------------------------------------------------------------
# Analytic supports (local frame).  Each returns a valid maximizer of
# <d, x> over the shape; for degenerate direction components any maximizer
# is acceptable, so e.g. sign(0) -> face center is fine.
# ---------------------------------------------------------------------------


def _safe_unit(v, eps=1e-20):
    n = jnp.linalg.norm(v)
    return jnp.where(n > eps, v / jnp.where(n > eps, n, 1.0), jnp.zeros_like(v))


def sphere_support(d: jnp.ndarray, radius: jnp.ndarray) -> jnp.ndarray:
    return radius * _safe_unit(d)


def box_support(d: jnp.ndarray, half_extents: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(d >= 0.0, half_extents, -half_extents)


def capsule_support(d: jnp.ndarray, radius: jnp.ndarray, half_len: jnp.ndarray) -> jnp.ndarray:
    """Capsule along local z axis: segment (0,0,-h)..(0,0,+h) with radius."""
    end = jnp.where(d[2] >= 0.0, half_len, -half_len)
    return radius * _safe_unit(d) + jnp.array([0.0, 0.0, 1.0], d.dtype) * end


def cylinder_support(d: jnp.ndarray, radius: jnp.ndarray, half_height: jnp.ndarray) -> jnp.ndarray:
    """Cylinder along local z axis."""
    dp = d.at[2].set(0.0)
    rim = radius * _safe_unit(dp)
    cap = jnp.where(d[2] >= 0.0, half_height, -half_height)
    return rim.at[2].add(cap)
