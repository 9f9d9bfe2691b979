"""Result / status types for narrow-phase queries.

The reference reports failures interactively (WRITE + PAUSE/STOP on
impossible states, GCLIB_GJKEPA.f90:301,338,1371) and silently returns
non-hit after iteration caps (:86-89,:186-189) or zeros after the EPA cap
(:299-303).  A batched device program can never halt, so every query
instead returns a per-query ``status`` code mirroring those branches
(SURVEY.md §5.3), plus
iteration counters as free observability (SURVEY.md §5.1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Status:
    """Per-query status codes (int32)."""

    MISS_BROADPHASE = 0   # rejected by bounding-sphere envelope (:76-77)
    MISS_INIT = 1         # init phase gave up: 99 coincident dirs (:86-89)
    #                       or v3/v4 degenerate (:123-127,:157-160)
    MISS_GJK = 2          # GJK declared non-hit: degenerate simplex
    #                       (:199-207), stagnation (:219-234), or cap (:186)
    HIT = 3               # origin contained; EPA converged
    HIT_EPA_CAP = 4       # hit, but EPA hit its iteration cap (:299-303);
    #                       depth/normal are best-effort, reference zeroes them
    HIT_EPA_DEGENERATE = 5  # hit, but EPA could not expand (duplicate support)


class CollisionResult(NamedTuple):
    """Full narrow-phase query result (a pytree; every leaf batches).

    Mirrors the reference output surface (GCLIB_GJKEPA.f90:47-52) plus the
    status/iteration extensions and the miss-path ``distance`` capability
    (SURVEY.md §3.2).
    """

    hit: jnp.ndarray                # bool    — collision_       (:47)
    colli_type: jnp.ndarray         # int32   — colliType_ 0/1/2 (:48)
    nearest_points: jnp.ndarray     # (2,3)   — nearest_points_  (:49)
    normal: jnp.ndarray             # (3,)    — collision_normal_ (:50)
    contact_point: jnp.ndarray      # (3,)    — collision_point_ (:51)
    depth: jnp.ndarray              # ()      — penetration_depth_ (:52)
    # -- extensions (absent in reference) ------------------------------------
    distance: jnp.ndarray           # ()      — separation lower bound on miss
    status: jnp.ndarray             # int32   — Status code
    gjk_iters: jnp.ndarray          # int32   — GJK loop iterations used
    epa_iters: jnp.ndarray          # int32   — EPA expansion iterations used
