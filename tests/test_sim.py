"""Rigid-body mini-sim tests (bench config c5, scaled down for CPU CI)."""

import jax
import jax.numpy as jnp
import numpy as np

from gjkepa.sim.rigid import SimConfig, SimState, init_boxes, sim_step


def run_steps(state, scfg, n):
    diag = None
    for _ in range(n):
        state, diag = sim_step(state, scfg)
    jax.block_until_ready(state.pos)
    return state, diag


def test_boxes_fall_and_settle():
    state = init_boxes(64, height=3.0, spread=5.0)
    scfg = SimConfig(max_pairs=512)
    s2, diag = run_steps(state, scfg, 150)
    pos = np.asarray(s2.pos)
    assert np.isfinite(pos).all()
    # everything fell (below initial height) and nothing tunneled through
    # the floor by more than a contact slop
    assert pos[:, 2].max() < 3.5 + 2.0
    assert pos[:, 2].min() > -0.5
    # ground contacts exist; some boxes touch each other
    assert int(diag["n_ground"]) > 10
    # velocities bounded (no explosion)
    assert np.abs(np.asarray(s2.vel)).max() < 50.0


def test_energy_dissipates():
    state = init_boxes(32, height=4.0, spread=4.0)
    scfg = SimConfig(max_pairs=256)
    s_mid, _ = run_steps(state, scfg, 60)
    s_end, _ = run_steps(s_mid, scfg, 240)
    ke_mid = float(jnp.sum(s_mid.vel ** 2))
    ke_end = float(jnp.sum(s_end.vel ** 2))
    # after settling, kinetic energy must be far below free-fall levels
    assert ke_end < max(ke_mid, 1.0) * 2.0
    assert np.isfinite(np.asarray(s_end.quat)).all()
    # quaternions stay normalized
    qn = np.linalg.norm(np.asarray(s_end.quat), axis=1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-4)


def test_stack_does_not_interpenetrate():
    # two boxes dropped exactly on top of each other
    half = jnp.full((2, 3), 0.5, jnp.float32)
    state = SimState(
        pos=jnp.array([[0.0, 0, 0.6], [0.0, 0, 2.0]], jnp.float32),
        quat=jnp.zeros((2, 4), jnp.float32).at[:, 0].set(1.0),
        vel=jnp.zeros((2, 3), jnp.float32),
        angvel=jnp.zeros((2, 3), jnp.float32),
        half=half,
    )
    scfg = SimConfig(max_pairs=16)
    s2, _ = run_steps(state, scfg, 240)
    pos = np.asarray(s2.pos)
    # bottom box on the floor, top box roughly one box-height above
    assert abs(pos[0, 2] - 0.5) < 0.15
    assert pos[1, 2] > pos[0, 2] + 0.7


def test_three_box_stack_stays_stable():
    # a 3-box stack must stay within tolerance for
    # 300 steps — requires the face-clip contact manifold (single-point
    # contacts make stacks only marginally stable).
    half = jnp.full((3, 3), 0.5, jnp.float32)
    state = SimState(
        pos=jnp.array([[0.0, 0, 0.55], [0.0, 0, 1.6], [0.0, 0, 2.65]],
                      jnp.float32),
        quat=jnp.zeros((3, 4), jnp.float32).at[:, 0].set(1.0),
        vel=jnp.zeros((3, 3), jnp.float32),
        angvel=jnp.zeros((3, 3), jnp.float32),
        half=half,
    )
    scfg = SimConfig(max_pairs=16)
    s2, _ = run_steps(state, scfg, 300)
    pos = np.asarray(s2.pos)
    # stack order preserved with ~1-box spacing, no lateral walk-off
    assert abs(pos[0, 2] - 0.5) < 0.15
    assert abs(pos[1, 2] - 1.5) < 0.25
    assert abs(pos[2, 2] - 2.5) < 0.35
    assert np.abs(pos[:, :2]).max() < 0.3


def _onehot_gather_rows(body_vals, idx):
    """Reference: rows of `body_vals` picked by a (P, N) one-hot matmul."""
    n = body_vals.shape[0]
    oh = (idx[:, None] == jnp.arange(n)[None, :]).astype(body_vals.dtype)
    flat = body_vals.reshape(n, -1)
    return (oh @ flat).reshape((-1,) + body_vals.shape[1:])


def _onehot_scatter_add_rows(pair_vals, idx, n):
    """Reference: per-pair rows summed per body by a one-hot contraction."""
    oh = (idx[:, None] == jnp.arange(n)[None, :]).astype(pair_vals.dtype)
    return jnp.einsum("pn,pi->ni", oh, pair_vals)


def test_gather_segment_sum_step_equals_onehot(monkeypatch):
    """The step's body<->pair data movement (row gathers and segment sums)
    equals the dense one-hot matmul formulation it replaced, on a pile
    with contacts, over a few steps."""
    from gjkepa import GJKEPAConfig
    from gjkepa.sim import rigid

    state = init_boxes(48, height=0.6, spread=4.5, dtype=jnp.float64)
    scfg = SimConfig(max_pairs=1024)
    cfg = GJKEPAConfig()
    raw = sim_step.__wrapped__
    # a fresh closure per jit: JAX caches traces by function identity, and
    # the reference must be traced with the helpers patched
    step = jax.jit(lambda s: raw(s, scfg, cfg))
    ref_state = state
    for _ in range(3):
        state, diag = step(state)
    assert int(diag["n_contacts"]) > 5
    with monkeypatch.context() as m:
        m.setattr(rigid, "_gather_rows", _onehot_gather_rows)
        m.setattr(rigid, "_scatter_add_rows", _onehot_scatter_add_rows)
        ref_step = jax.jit(lambda s: raw(s, scfg, cfg))
        for _ in range(3):
            ref_state, _ = ref_step(ref_state)
    for name in ("pos", "quat", "vel", "angvel"):
        np.testing.assert_allclose(np.asarray(getattr(state, name)),
                                   np.asarray(getattr(ref_state, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
