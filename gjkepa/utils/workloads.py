"""Seeded inputs of the bench configurations (c1-c5).

``bench.py`` times these and ``chip_smoke.py`` checks the engine on them,
so both run the same data.  Everything is float32 (the precision of
``GJKEPAConfig.for_f32``) and made from a numpy Generator.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["random_hulls", "cube_pair", "analytic_pairs", "hull_shape_pairs",
           "deep_pairs", "SimScene", "SIM_1K", "SIM_16K"]


def random_hulls(rng, b, n, spread=0.8):
    """(b, n, 3) vertex clouds: points on a unit sphere pulled inward by up
    to half, each cloud offset by a normal(0, spread) center."""
    v = rng.normal(size=(b, n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= 0.5 + 0.5 * rng.random((b, n, 1))
    return (v + rng.normal(size=(b, 1, 3)) * spread).astype(np.float32)


def cube_pair():
    """c1: two unit cubes overlapping by 0.5 along x (depth exactly 0.5)."""
    half = 0.5
    corners = np.array([[x, y, z] for x in (-half, half)
                        for y in (-half, half) for z in (-half, half)],
                       np.float32)
    return corners, corners + np.array([0.5, 0, 0], np.float32)


def _four_kinds(rng, q, scale, sizes):
    from ..models import boxes, capsules, concat_shapes, cylinders, spheres

    (r_s, w_s), (h_b, w_b), (r_c, w_c, l_c, v_c), (r_y, w_y, l_y, v_y) = sizes

    def pos():
        return rng.normal(size=(q, 3)).astype(np.float32) * scale

    def u(lo, width, shape=(q,)):
        return lo + width * rng.random(shape).astype(np.float32)

    return concat_shapes(
        spheres(u(r_s, w_s), pos=pos()),
        boxes(u(h_b, w_b, (q, 3)), pos=pos()),
        capsules(u(r_c, w_c), u(l_c, v_c), pos=pos()),
        cylinders(u(r_y, w_y), u(l_y, v_y), pos=pos()),
    )


def analytic_pairs(rng, b=65536):
    """c3: b mixed analytic pairs, a quarter each of spheres, boxes,
    capsules and cylinders per side (same-kind pairs), centers spread 1.2."""
    sizes = ((0.4, 0.4), (0.3, 0.4), (0.2, 0.2, 0.3, 0.3), (0.2, 0.3, 0.3, 0.3))
    q = b // 4
    return _four_kinds(rng, q, 1.2, sizes), _four_kinds(rng, q, 1.2, sizes)


def hull_shape_pairs(rng, b=16384, n=24):
    """c3b: b (hull, analytic shape) pairs; the shapes are a quarter each
    of the four kinds, centers spread 0.8."""
    hulls = random_hulls(rng, b, n)
    sizes = ((0.3, 0.4), (0.25, 0.3), (0.2, 0.2, 0.25, 0.25),
             (0.2, 0.25, 0.25, 0.25))
    return hulls, _four_kinds(rng, b // 4, 0.8, sizes)


def deep_pairs(rng, b=16384, n=24):
    """c4: b deep-penetration hull pairs — a radius-2 cloud around the
    origin against a radius-0.5 cloud near it; nearly every pair hits and
    runs EPA for many iterations."""
    big = random_hulls(rng, b, n, spread=0.0) * 2.0
    small = random_hulls(rng, b, n, spread=0.0) * 0.5
    small += rng.normal(size=(b, 1, 3)).astype(np.float32) * 0.2
    return big, small


class SimScene(NamedTuple):
    """c5: ``init_boxes(n, height=..., spread=...)`` stepped `steps` times
    with ``SimConfig(max_pairs=...)``."""
    n: int
    max_pairs: int
    steps: int
    height: float
    spread: float


SIM_1K = SimScene(1024, 8192, 10, 6.0, 14.0)
SIM_16K = SimScene(16384, 65536, 3, 8.0, 55.0)
