"""gjkepa — a batch convex-collision framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
``xiejihong0306/collision-detect-GJK-EPA`` (the GCLIB_GJKEPA Fortran
narrow-phase): boolean intersection, penetration depth, contact normal,
contact point, nearest/witness points and contact-type classification for
pairs of convex shapes — batched, jittable, shardable across device meshes.

Public surface:
  * :func:`gjkepa` / :func:`gjkepa_batch` — the reference's query API over
    (padded) convex vertex clouds.
  * :func:`collide_supports` + analytic shapes — closed-form support maps.
  * :mod:`gjkepa.ops` — geometry kernel, support maps, GJK, EPA,
    contact derivation, broadphase.
  * :mod:`gjkepa.models` — shape types (hulls + analytic primitives).
  * :mod:`gjkepa.parallel` — device-mesh sharding of the pair axis.
  * :mod:`gjkepa.sim` — rigid-body mini-sim demo (broadphase ->
    narrowphase -> impulse step).
  * :mod:`gjkepa.utils` — convex-hull preprocessing, fixtures.
"""

from .api import collide_shapes_batch, collide_supports, gjkepa, gjkepa_batch
from .config import DEFAULT_CONFIG, GJKEPAConfig
from .ops.manifold import (ManifoldResult, manifold_batch,
                           manifold_hull_shape_batch, manifold_shapes_batch)
from .types import CollisionResult, Status

__version__ = "0.2.0"

__all__ = [
    "gjkepa",
    "gjkepa_batch",
    "collide_supports",
    "collide_shapes_batch",
    "manifold_batch",
    "manifold_hull_shape_batch",
    "manifold_shapes_batch",
    "ManifoldResult",
    "GJKEPAConfig",
    "DEFAULT_CONFIG",
    "CollisionResult",
    "Status",
    "__version__",
]
