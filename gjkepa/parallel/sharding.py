"""Device-mesh parallelism for the pair axis.

The reference's entire parallelism story is OpenMP thread data-parallelism
over independent pair queries (23 THREADPRIVATE declarations, SURVEY.md
§2.4).  The data-parallel equivalent here is:

  * within a device: ``vmap`` over the pair axis (api.gjkepa_batch);
  * across devices: a 1-D ``jax.sharding.Mesh`` sharding the pair axis —
    queries are independent, so no collective traffic is needed for the
    queries themselves; cross-device reductions (global contact counts,
    simulation aggregates) are one ``psum`` inside ``shard_map``.  A flat
    mesh suits GPUs joined all to all by NVLink.

The tests run the same code on 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, GJKEPAConfig
from ..types import CollisionResult
from .. import api

__all__ = ["pair_mesh", "shard_pairs", "gjkepa_batch_sharded", "contact_count_sharded"]


def pair_mesh(n_devices: int | None = None, axis: str = "pairs") -> Mesh:
    """1-D device mesh over the pair axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_pairs(mesh: Mesh, *arrays, axis: str = "pairs"):
    """Place batch arrays with their leading (pair) axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(axis))
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out[0] if len(out) == 1 else out


@functools.lru_cache(maxsize=None)
def _sharded_xla_fn(mesh, axis, cfg, has_m1, has_m2):
    """Cached jitted shard_map program (a fresh closure per call would
    retrace on every invocation — hundreds of ms of host time)."""
    spec = P(axis)
    m_spec1 = spec if has_m1 else None
    m_spec2 = spec if has_m2 else None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, spec, m_spec1, m_spec2),
        out_specs=spec,
        check_vma=False,
    )
    def local(p1s, p2s, m1s, m2s):
        return api.gjkepa_batch(p1s, p2s, m1s, m2s, cfg=cfg)

    return jax.jit(local)


def gjkepa_batch_sharded(
    mesh: Mesh,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    mask1: jnp.ndarray | None = None,
    mask2: jnp.ndarray | None = None,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    axis: str = "pairs",
) -> CollisionResult:
    """Batch query with the pair axis sharded across the mesh via shard_map.

    Each device runs the jitted per-shard program on its local slice;
    results come back sharded the same way.  Zero collectives — exactly the
    communication profile of the reference's per-thread batching.
    """
    fn = _sharded_xla_fn(mesh, axis, cfg, mask1 is not None, mask2 is not None)
    return fn(p1, p2, mask1, mask2)


@functools.lru_cache(maxsize=None)
def _contact_count_fn(mesh, axis, cfg):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
        # the GJK while-loop carries are unsharded scalars per lane; skip
        # the varying-manual-axis type check (same as gjkepa_batch_sharded)
        check_vma=False,
    )
    def local(p1s, p2s):
        r = api.gjkepa_batch(p1s, p2s, cfg=cfg)
        return jax.lax.psum(jnp.sum(r.hit.astype(jnp.int32)), axis)

    return jax.jit(local)


def contact_count_sharded(
    mesh: Mesh,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    cfg: GJKEPAConfig = DEFAULT_CONFIG,
    axis: str = "pairs",
):
    """Global hit count over a sharded pair batch: per-shard narrowphase +
    one psum over the mesh — the only cross-device communication this
    domain needs (SURVEY.md §5.8)."""
    return _contact_count_fn(mesh, axis, cfg)(p1, p2)
