"""Shape models: batched analytic primitives + convex hulls.

The reference operates on raw convex vertex clouds only.  Analytic shapes
(sphere/box/capsule/cylinder) are the bench config c3 capability
extension: closed-form support maps dispatched by a type tag, stored as a
struct-of-arrays batch so a mixed 64k-pair workload compiles to one fused
program (``lax.switch`` under vmap lowers to selects over the four cheap
branches — no divergence).

World-frame support: ``s_world(d) = R @ s_local(R^T d) + t``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.support import (
    SupportResult,
    box_support,
    capsule_support,
    cylinder_support,
    sphere_support,
)

__all__ = [
    "SPHERE", "BOX", "CAPSULE", "CYLINDER",
    "ShapeBatch", "spheres", "boxes", "capsules", "cylinders", "concat_shapes",
    "shape_support_world", "make_shape_pair_support",
]

SPHERE = 0
BOX = 1
CAPSULE = 2
CYLINDER = 3


class ShapeBatch(NamedTuple):
    """SoA batch of analytic shapes.

    params layout by kind:
      SPHERE:   [radius, 0, 0]
      BOX:      half_extents (3,)
      CAPSULE:  [radius, half_length, 0]   (axis = local z)
      CYLINDER: [radius, half_height, 0]   (axis = local z)
    """

    kind: jnp.ndarray    # (B,)   int32
    params: jnp.ndarray  # (B,3)  float
    pos: jnp.ndarray     # (B,3)  float world position
    rot: jnp.ndarray     # (B,3,3) float local->world rotation

    def __len__(self):
        return self.kind.shape[0]


def _mk(kind, params, pos, rot, dtype):
    b = params.shape[0]
    pos = jnp.zeros((b, 3), dtype) if pos is None else jnp.asarray(pos, dtype)
    if rot is None:
        rot = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (b, 3, 3))
    else:
        rot = jnp.asarray(rot, dtype)
    return ShapeBatch(jnp.full((b,), kind, jnp.int32),
                      jnp.asarray(params, dtype), pos, rot)


def spheres(radius, pos=None, rot=None, dtype=jnp.float32):
    r = jnp.asarray(radius, dtype).reshape(-1, 1)
    params = jnp.concatenate([r, jnp.zeros((r.shape[0], 2), dtype)], axis=1)
    return _mk(SPHERE, params, pos, rot, dtype)


def boxes(half_extents, pos=None, rot=None, dtype=jnp.float32):
    return _mk(BOX, jnp.asarray(half_extents, dtype).reshape(-1, 3), pos, rot, dtype)


def capsules(radius, half_length, pos=None, rot=None, dtype=jnp.float32):
    r = jnp.asarray(radius, dtype).reshape(-1, 1)
    h = jnp.asarray(half_length, dtype).reshape(-1, 1)
    params = jnp.concatenate([r, h, jnp.zeros((r.shape[0], 1), dtype)], axis=1)
    return _mk(CAPSULE, params, pos, rot, dtype)


def cylinders(radius, half_height, pos=None, rot=None, dtype=jnp.float32):
    r = jnp.asarray(radius, dtype).reshape(-1, 1)
    h = jnp.asarray(half_height, dtype).reshape(-1, 1)
    params = jnp.concatenate([r, h, jnp.zeros((r.shape[0], 1), dtype)], axis=1)
    return _mk(CYLINDER, params, pos, rot, dtype)


def concat_shapes(*batches: ShapeBatch) -> ShapeBatch:
    return ShapeBatch(*(jnp.concatenate(parts) for parts in zip(*batches)))


def _support_local(kind, d, params):
    return lax.switch(
        kind,
        [
            lambda d, p: sphere_support(d, p[0]),
            lambda d, p: box_support(d, p),
            lambda d, p: capsule_support(d, p[0], p[1]),
            lambda d, p: cylinder_support(d, p[0], p[1]),
        ],
        d, params,
    )


def shape_support_world(kind, params, pos, rot, d):
    """Support point of one shape in world frame along world direction d."""
    d_local = rot.T @ d
    s_local = _support_local(kind, d_local, params)
    return rot @ s_local + pos


def make_shape_pair_support(kind_a, params_a, pos_a, rot_a,
                            kind_b, params_b, pos_b, rot_b):
    """Minkowski support callable for one analytic shape pair (vmap outside)."""

    def support(d):
        a = shape_support_world(kind_a, params_a, pos_a, rot_a, d)
        b = shape_support_world(kind_b, params_b, pos_b, rot_b, -d)
        return SupportResult(a - b, a, b)

    return support
