"""Every float32 contraction of a public entry point asks for HIGHEST
precision.  On the GPU a DEFAULT-precision f32 ``dot_general`` may run in
TF32 (~10 mantissa bits), and the engine moves data with one-hot
contractions, so a single missed scope would put ~1e-3 relative error into
depths and witness points.  The CPU tier runs f64 and cannot see that
numerically, so this reads the lowered StableHLO instead."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import (GJKEPAConfig, collide_shapes_batch, gjkepa, gjkepa_batch,
                    manifold_batch, manifold_hull_shape_batch,
                    manifold_shapes_batch)
from gjkepa.api import (collide_hull_shape_batch, gjk_distance_batch,
                        gjk_distance_shapes_batch)
from gjkepa.models import boxes, spheres
from gjkepa.sim.rigid import SimConfig, init_boxes, sim_step

CFG = GJKEPAConfig.for_f32()
B, N = 8, 8

_DOT = re.compile(r"stablehlo\.dot_general .*precision = \[(\w+), (\w+)\]"
                  r" : \(tensor<[^>]*f(?:16|32|64)>")


def _hulls():
    rng = np.random.default_rng(0)
    return (jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32),
            jnp.asarray(rng.normal(size=(B, N, 3)), jnp.float32))


def _shapes():
    h = jnp.full((B, 3), 0.5, jnp.float32)
    return (boxes(h, pos=jnp.zeros((B, 3), jnp.float32)),
            spheres(jnp.full((B,), 0.5, jnp.float32),
                    pos=jnp.full((B, 3), 0.4, jnp.float32)))


def _query():
    z3 = jnp.zeros((B, 3), jnp.float32)
    return (z3.at[:, 0].set(1.0), jnp.full((B,), 0.1, jnp.float32),
            jnp.ones((B,), bool), z3)


def _lower(name):
    p1, p2 = _hulls()
    a, b = _shapes()
    n, d, h, c = _query()
    if name == "gjkepa":
        return gjkepa.lower(p1[0], p2[0], cfg=CFG)
    if name == "gjkepa_batch":
        return gjkepa_batch.lower(p1, p2, cfg=CFG)
    if name == "gjkepa_batch_chunked":
        return gjkepa_batch.lower(p1, p2, cfg=CFG, chunk_size=4)
    if name == "gjk_distance_batch":
        return gjk_distance_batch.lower(p1, p2, cfg=CFG)
    if name == "collide_shapes_batch":
        return collide_shapes_batch.lower(a, b, cfg=CFG)
    if name == "gjk_distance_shapes_batch":
        return gjk_distance_shapes_batch.lower(a, b, cfg=CFG)
    if name == "collide_hull_shape_batch":
        return collide_hull_shape_batch.lower(p1, b, cfg=CFG)
    if name == "manifold_batch":
        return jax.jit(lambda *x: manifold_batch(*x, cfg=CFG)).lower(
            p1, p2, n, d, h, c)
    if name == "manifold_shapes_batch":
        return jax.jit(lambda *x: manifold_shapes_batch(*x, cfg=CFG)).lower(
            a, b, n, d, h, c)
    if name == "manifold_hull_shape_batch":
        return jax.jit(lambda *x: manifold_hull_shape_batch(*x, cfg=CFG)).lower(
            p1, b, n, d, h, c)
    if name == "sim_step":
        return sim_step.lower(init_boxes(16), SimConfig(max_pairs=64))
    if name == "gjkepa_batch_sharded":
        from gjkepa.parallel import gjkepa_batch_sharded, pair_mesh
        mesh = pair_mesh(2)
        return jax.jit(lambda x, y: gjkepa_batch_sharded(mesh, x, y, cfg=CFG)
                       ).lower(p1, p2)
    if name == "contact_count_sharded":
        from gjkepa.parallel import contact_count_sharded, pair_mesh
        mesh = pair_mesh(2)
        return jax.jit(lambda x, y: contact_count_sharded(mesh, x, y, cfg=CFG)
                       ).lower(p1, p2)
    if name == "checked_gjkepa_batch":
        from gjkepa.debug import _checked_jit
        return _checked_jit.lower(p1, p2, CFG)
    raise ValueError(name)


ENTRY_POINTS = [
    "gjkepa", "gjkepa_batch", "gjkepa_batch_chunked", "gjk_distance_batch",
    "collide_shapes_batch", "gjk_distance_shapes_batch",
    "collide_hull_shape_batch", "manifold_batch", "manifold_shapes_batch",
    "manifold_hull_shape_batch", "sim_step", "gjkepa_batch_sharded",
    "contact_count_sharded", "checked_gjkepa_batch",
]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_float_contractions_are_highest(name):
    text = _lower(name).as_text()
    dots = [line for line in text.splitlines()
            if "stablehlo.dot_general" in line]
    float_dots = [m.groups() for m in map(_DOT.search, dots) if m]
    assert float_dots, f"{name}: no float dot_general lowered"
    low = [g for g in float_dots if g != ("HIGHEST", "HIGHEST")]
    assert not low, f"{name}: {len(low)} of {len(float_dots)} float " \
                    f"contractions below HIGHEST: {low[:3]}"


def test_default_precision_is_detected():
    """The pattern sees a DEFAULT-precision f32 contraction (the check
    above cannot pass vacuously)."""
    x = jnp.ones((4, 3), jnp.float32)
    line = next(l for l in jax.jit(lambda a: a @ a.T).lower(x).as_text()
                .splitlines() if "dot_general" in l)
    assert _DOT.search(line).groups() == ("DEFAULT", "DEFAULT")
