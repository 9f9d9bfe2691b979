"""Tests that need a GPU (marker ``gpu``).  Run them on a machine with one:

    GJKEPA_GPU_TESTS=1 python -m pytest tests/ -n 0 -m gpu

Elsewhere the ``gpu_device`` fixture skips them.  ``chip_smoke.py`` is the
full-size check; these are the quick ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gjkepa import GJKEPAConfig, gjkepa_batch
from gjkepa.utils.workloads import random_hulls

CFG = GJKEPAConfig.for_f32()


@pytest.mark.gpu
def test_f32_batch_on_gpu_matches_cpu(gpu_device):
    """The same jitted f32 query on the GPU and on the CPU backend: hit
    verdicts agree and depths within chip_smoke's CPU bound."""
    rng = np.random.default_rng(0)
    p1, p2 = random_hulls(rng, 512, 32), random_hulls(rng, 512, 32)
    f = jax.jit(lambda a, b: gjkepa_batch(a, b, cfg=CFG))
    rg = jax.device_get(f(*jax.device_put((p1, p2), gpu_device)))
    rc = jax.device_get(f(*jax.device_put((p1, p2), jax.devices("cpu")[0])))
    near = np.minimum(np.where(rg.hit, rg.depth, 1.0),
                      np.where(rc.hit, rc.depth, 1.0)) < 1e-4
    assert not ((rg.hit != rc.hit) & ~near).any()
    both = rg.hit & rc.hit
    assert both.sum() > 50
    np.testing.assert_allclose(rg.depth[both], rc.depth[both], atol=1e-4)


@pytest.mark.gpu
def test_sim_step_on_gpu(gpu_device):
    """A settling pile with box and ground contacts: 20 steps stay finite
    and above the floor, and the first step matches the CPU backend."""
    from gjkepa.sim.rigid import SimConfig, init_boxes, sim_step

    state = jax.device_get(init_boxes(256, height=0.6, spread=9.0))
    step = jax.jit(lambda s: sim_step(s, SimConfig(max_pairs=2048)))
    s, diag = step(jax.device_put(state, gpu_device))
    ref, _ = step(jax.device_put(state, jax.devices("cpu")[0]))
    np.testing.assert_allclose(np.asarray(s.pos), np.asarray(ref.pos),
                               atol=2e-5)
    for _ in range(19):
        s, diag = step(s)
    assert int(diag["n_contacts"]) > 0 and int(diag["n_ground"]) > 0
    assert bool(jnp.all(jnp.isfinite(s.pos)))
    assert float(jnp.min(s.pos[:, 2])) > 0.0
