"""Broadphase: sweep-and-prune candidate pairs vs the O(n^2) oracle,
and the overflow-accounting contract."""

import numpy as np
import jax.numpy as jnp

from gjkepa.ops.broadphase import (grid_candidate_pairs,
                                       swept_candidate_pairs)


def _pair_set(pairs, valid):
    p = np.asarray(pairs)[np.asarray(valid)]
    return {frozenset((int(i), int(j))) for i, j in p if i != j}


def _brute_pairs(centers, radii, inflate):
    n = len(centers)
    out = set()
    for i in range(n):
        for j in range(i + 1, n):
            if np.linalg.norm(centers[i] - centers[j]) <= radii[i] + radii[j] + inflate:
                out.add(frozenset((i, j)))
    return out


def test_swept_matches_brute_force(rng):
    n = 256
    centers = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    radii = (0.3 + 0.4 * rng.random(n)).astype(np.float32)
    pairs, valid, n_cand, overflow = swept_candidate_pairs(
        jnp.asarray(centers), jnp.asarray(radii), max_pairs=8192,
        window=128, inflate=0.5)
    assert not bool(overflow)
    got = _pair_set(pairs, valid)
    want = _brute_pairs(centers, radii, 0.5)
    assert got == want
    assert int(n_cand) == len(want)


def test_swept_matches_grid_candidates(rng):
    """Same admission rule => same candidate set as the O(n^2) sweep."""
    n = 128
    centers = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    radii = (0.3 + 0.3 * rng.random(n)).astype(np.float32)
    g_pairs, g_valid, g_n = grid_candidate_pairs(
        jnp.asarray(centers), jnp.asarray(radii), cell_size=0.5,
        max_pairs=4096)
    s_pairs, s_valid, s_n, overflow = swept_candidate_pairs(
        jnp.asarray(centers), jnp.asarray(radii), max_pairs=4096,
        window=127, inflate=0.5)
    assert not bool(overflow)
    assert _pair_set(g_pairs, g_valid) == _pair_set(s_pairs, s_valid)
    assert int(g_n) == int(s_n)


def test_swept_window_overflow_reported(rng):
    """A window too small for a dense cluster must raise the overflow flag
    (candidates WOULD be dropped) — never silently lose contacts."""
    n = 64
    centers = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.1  # one clump
    radii = np.full(n, 0.5, np.float32)
    _, _, _, overflow = swept_candidate_pairs(
        jnp.asarray(centers), jnp.asarray(radii), max_pairs=4096,
        window=8, inflate=0.5)
    assert bool(overflow)


def test_swept_row_overflow_reported(rng):
    """max_pairs too small for the true candidate count => overflow."""
    n = 64
    centers = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.5
    radii = np.full(n, 0.5, np.float32)
    _, _, n_cand, overflow = swept_candidate_pairs(
        jnp.asarray(centers), jnp.asarray(radii), max_pairs=64,
        window=63, inflate=0.5)
    assert int(n_cand) > 64
    assert bool(overflow)


def test_sim_step_surfaces_overflow():
    """sim_step diagnostics expose the broadphase overflow flag."""
    from gjkepa.sim.rigid import SimConfig, init_boxes, sim_step

    state = init_boxes(32, height=2.0, spread=6.0)
    _, diag = sim_step(state, SimConfig(max_pairs=512))
    assert "candidate_overflow" in diag
    assert not bool(diag["candidate_overflow"])
    # cram the same boxes into a tiny volume with a tiny pair budget
    import jax.numpy as jnp
    crammed = state._replace(pos=state.pos * 0.05)
    _, diag2 = sim_step(crammed, SimConfig(max_pairs=32))
    assert bool(diag2["candidate_overflow"])
