"""Rigid-body mini-sim: falling boxes (bench config c5).

Demonstrates the full pipeline in one jitted step: sweep-and-prune
broadphase (fixed-capacity candidate pairs, overflow-accounted) -> batched
GJK/EPA narrowphase over analytic box supports -> up-to-4-point contact
manifolds via the PUBLIC manifold op -> ground-plane contacts -> a few
iterations of a sequential-impulse solver with Baumgarte positional bias
-> semi-implicit Euler integration.  Everything is fixed-shape; invalid candidate lanes are
masked, so the whole step compiles to one XLA program and shards over a
device mesh along the body/pair axes (see __graft_entry__.dryrun_multichip).

The reference is a narrow-phase library intended to be driven by exactly
this kind of host loop (one pair per OMP thread, SURVEY.md §0); here the
loop itself is on-device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GJKEPAConfig
from ..models.shapes import make_shape_pair_support, BOX
from ..ops.broadphase import swept_candidate_pairs
from ..ops.epa import run_epa
from ..ops.gjk import run_gjk
from ..precision import highest_precision

__all__ = ["SimState", "SimConfig", "init_boxes", "sim_step"]


class SimState(NamedTuple):
    pos: jnp.ndarray       # (N,3)
    quat: jnp.ndarray      # (N,4)  (w,x,y,z)
    vel: jnp.ndarray       # (N,3)
    angvel: jnp.ndarray    # (N,3)
    half: jnp.ndarray      # (N,3)  box half extents


class SimConfig(NamedTuple):
    dt: float = 1.0 / 60.0
    gravity: float = -9.81
    max_pairs: int = 8192
    bp_window: int = 64          # sweep-and-prune neighbor window
    solver_iters: int = 4
    baumgarte: float = 0.2
    restitution: float = 0.0
    friction: float = 0.4
    ground_z: float = 0.0


def quat_to_mat(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_integrate(q, w, dt):
    """q' = q + dt/2 * (0,w) * q, renormalized (semi-implicit)."""
    qw, qx, qy, qz = q[0], q[1], q[2], q[3]
    wx, wy, wz = w[0], w[1], w[2]
    dq = 0.5 * jnp.array([
        -wx * qx - wy * qy - wz * qz,
        wx * qw + wy * qz - wz * qy,
        -wx * qz + wy * qw + wz * qx,
        wx * qy - wy * qx + wz * qw,
    ])
    qn = q + dt * dq
    return qn / jnp.linalg.norm(qn)


def init_boxes(n: int, seed: int = 0, spread: float = 12.0, height: float = 10.0,
               dtype=jnp.float32) -> SimState:
    """N boxes in a jittered grid above the ground plane."""
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    side = int(jnp.ceil(n ** (1 / 3)))
    idx = jnp.arange(n)
    gx = (idx % side).astype(dtype)
    gy = ((idx // side) % side).astype(dtype)
    gz = (idx // (side * side)).astype(dtype)
    spacing = spread / side
    pos = jnp.stack([
        (gx - side / 2) * spacing,
        (gy - side / 2) * spacing,
        gz * spacing + height,
    ], axis=1)
    pos = pos + jax.random.uniform(k1, (n, 3), dtype, -0.2, 0.2) * spacing * 0.3
    quat = jnp.zeros((n, 4), dtype).at[:, 0].set(1.0)
    half = jnp.full((n, 3), 0.5, dtype) * jax.random.uniform(k2, (n, 1), dtype, 0.8, 1.2)
    vel = jax.random.uniform(k3, (n, 3), dtype, -0.5, 0.5)
    return SimState(pos=pos, quat=quat, vel=vel,
                    angvel=jnp.zeros((n, 3), dtype), half=half)


def _pair_contacts(state: SimState, rot, pairs, valid, cfg: GJKEPAConfig):
    """Batched GJK/EPA over candidate box pairs (analytic box supports);
    the contact point is the witness midpoint along the EPA normal."""
    dtype = state.pos.dtype

    def one(i, j, active):
        sup = make_shape_pair_support(
            jnp.int32(BOX), state.half[i], state.pos[i], rot[i],
            jnp.int32(BOX), state.half[j], state.pos[j], rot[j],
        )
        g = run_gjk(sup, cfg, dtype=dtype, active=active)
        e = run_epa(sup, g.simplex, g.hit, cfg)
        s = sup(e.normal)
        point = 0.5 * (s.a + s.b)
        return g.hit, e.depth, e.normal, point

    return jax.vmap(one)(pairs[:, 0], pairs[:, 1], valid)


def _gather_rows(body_vals, idx):
    """(N, ...) body values -> (P, ...) values of the bodies in `idx`."""
    return body_vals[idx]


def _scatter_add_rows(pair_vals, idx, n):
    """(P, ...) per-pair values summed into (n, ...) per-body totals."""
    return jax.ops.segment_sum(pair_vals, idx, num_segments=n)


@functools.partial(jax.jit, static_argnames=("scfg", "cfg"))
@highest_precision
def sim_step(state: SimState, scfg: SimConfig = SimConfig(),
             cfg: GJKEPAConfig = GJKEPAConfig.for_f32()) -> tuple[SimState, dict]:
    """One physics step.  Returns (new_state, diagnostics)."""
    n = state.pos.shape[0]
    dtype = state.pos.dtype
    dt = jnp.asarray(scfg.dt, dtype)

    # gravity
    vel = state.vel + jnp.array([0.0, 0.0, scfg.gravity], dtype) * dt
    angvel = state.angvel

    rot = jax.vmap(quat_to_mat)(state.quat)

    # ---- broadphase ------------------------------------------------------
    # sweep-and-prune (O(n log n + n*window)) replaces an O(n^2)
    # masked sweep; `overflow` reports DROPPED candidates (window or
    # row-slot exhaustion) instead of silently losing contacts
    radii = jnp.linalg.norm(state.half, axis=1)
    pairs, valid, n_cand, bp_overflow = swept_candidate_pairs(
        state.pos, radii, max_pairs=scfg.max_pairs, window=scfg.bp_window,
        inflate=0.5)

    # ---- narrowphase -----------------------------------------------------
    hit, depth, normal, point = _pair_contacts(state, rot, pairs, valid, cfg)
    contact = hit & valid
    # up-to-4-point manifolds via the PUBLIC query-surface op — the sim is
    # just another consumer of the library.
    # Hit-compacted: the manifold op runs only on the first K contact rows
    # (cumsum-rank permutation);
    # contacts beyond K keep the single narrow-phase contact point (the
    # reference's own output) and the overflow is reported in diagnostics.
    from ..ops.manifold import manifold_shapes_batch
    from ..models.shapes import ShapeBatch

    n_pairs = pairs.shape[0]
    k_man = min(n_pairs, max(scfg.max_pairs // 4, 128))
    hit_i = contact.astype(jnp.int32)
    n_hit = jnp.sum(hit_i)
    dest = jnp.where(contact, jnp.cumsum(hit_i) - 1,
                     n_hit + jnp.cumsum(1 - hit_i) - 1)
    order = jnp.zeros((n_pairs,), jnp.int32).at[dest].set(
        jnp.arange(n_pairs, dtype=jnp.int32), unique_indices=True)
    take = order[:k_man]
    i_c, j_c = pairs[take, 0], pairs[take, 1]
    kinds = jnp.full((k_man,), BOX, jnp.int32)
    sa = ShapeBatch(kind=kinds, params=state.half[i_c],
                    pos=state.pos[i_c], rot=rot[i_c])
    sb = ShapeBatch(kind=kinds, params=state.half[j_c],
                    pos=state.pos[j_c], rot=rot[j_c])
    mf = manifold_shapes_batch(sa, sb, normal[take], depth[take],
                               contact[take], point[take],
                               cfg=cfg, poly_cap=4)  # box faces are quads
    # scatter back; beyond-K contacts fall back to the single contact point
    dc = jnp.minimum(dest, k_man - 1)
    in_k = contact & (dest < k_man)
    mpoints = jnp.where(in_k[:, None, None], mf.points[dc],
                        point[:, None, :])
    mdepths = jnp.where(in_k[:, None], mf.depths[dc],
                        depth[:, None] * (jnp.arange(4) == 0))
    single = (jnp.arange(4) == 0)[None, :] & contact[:, None]
    mmask = jnp.where(in_k[:, None], mf.mask[dc], single)
    mmask = mmask & valid[:, None]
    manifold_overflow = n_hit > k_man

    # ---- ground contacts: deepest corner of each box ---------------------
    corners = jnp.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)], dtype)  # (8,3)

    def ground_one(p, r, h):
        pts = p + (corners * h) @ r.T
        k = jnp.argmin(pts[:, 2])
        deepest = pts[k]
        pen = scfg.ground_z - deepest[2]
        return pen > 0, jnp.maximum(pen, 0.0), deepest

    g_hit, g_pen, g_point = jax.vmap(ground_one)(state.pos, rot, state.half)

    # ---- sequential impulses ----------------------------------------------
    inv_mass = 1.0 / (8.0 * state.half[:, 0] * state.half[:, 1] * state.half[:, 2])
    # box inertia: diagonal in the body frame, I_k = m/12 * sum_{j!=k} (2h_j)^2;
    # world-frame inverse tensor I_w^-1 = R diag(1/I_body) R^T, per step
    ext2 = (2 * state.half) ** 2
    i_body = (1.0 / inv_mass)[:, None] / 12.0 * (ext2.sum(axis=1, keepdims=True)
                                                 - ext2)
    inv_iw = jnp.einsum("nij,nj,nkj->nik", rot, 1.0 / i_body, rot)  # (N,3,3)

    def ang_term(inv_i, r, d):
        """dot(cross(r,d), I^-1 cross(r,d)) — the angular part of the
        effective mass along direction d at offset r."""
        c = jnp.cross(r, d)
        return jnp.einsum("pi,pij,pj->p", c, inv_i, c)

    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    bias = scfg.baumgarte / dt

    # Body<->pair data movement: row gathers and segment sums over the
    # candidate pair list.
    def gather_pairs(body_vals):            # (N,...) -> (P,...) twice
        return _gather_rows(body_vals, i_idx), _gather_rows(body_vals, j_idx)

    pos_i, pos_j = gather_pairs(state.pos)
    invm_i, invm_j = gather_pairs(inv_mass[:, None])
    invm_i, invm_j = invm_i[:, 0], invm_j[:, 0]
    invI_i, invI_j = gather_pairs(inv_iw)

    # restitution targets from the PRE-solve approach velocities (standard
    # Newton model: post-solve separation velocity = e * approach speed),
    # per manifold point
    vel_i0, vel_j0 = gather_pairs(vel)
    av_i0, av_j0 = gather_pairs(angvel)

    def _rest_slot(s):
        ra0 = mpoints[:, s] - pos_i
        rb0 = mpoints[:, s] - pos_j
        rel0 = (vel_j0 + jnp.cross(av_j0, rb0) - vel_i0 - jnp.cross(av_i0, ra0))
        vn0 = jnp.einsum("ij,ij->i", rel0, normal)
        return scfg.restitution * jnp.maximum(-vn0, 0.0)

    rest_pair = [_rest_slot(s) for s in range(4)]
    g_rg0 = g_point - state.pos
    vn_g0 = (vel + jnp.cross(angvel, g_rg0))[:, 2]
    rest_ground = scfg.restitution * jnp.maximum(-vn_g0, 0.0)

    def solve(carry, _):
        vel, angvel = carry
        vel_i, vel_j = gather_pairs(vel)
        av_i, av_j = gather_pairs(angvel)

        # --- pair contacts: up to 4 manifold points per pair, solved
        # Jacobi within the iteration (impulses from iteration-start
        # velocities, applied together), so the whole update is one
        # segment sum per body side ---
        imp_sum = jnp.zeros_like(normal)          # total impulse on body B
        tau_a = jnp.zeros_like(normal)            # total torque on body A
        tau_b = jnp.zeros_like(normal)
        for s in range(4):
            cpoint = mpoints[:, s]
            cdepth = mdepths[:, s]
            cmask = mmask[:, s]
            ra = cpoint - pos_i
            rb = cpoint - pos_j
            va = vel_i + jnp.cross(av_i, ra)
            vb = vel_j + jnp.cross(av_j, rb)
            # normal points A->B (moving B along +normal separates), so the
            # contact impulse pushes B along +normal
            rel = vb - va
            vn = jnp.einsum("ij,ij->i", rel, normal)
            k_n = (invm_i + invm_j
                   + ang_term(invI_i, ra, normal)
                   + ang_term(invI_j, rb, normal))
            # velocity bias = max(Baumgarte, restitution): summing them
            # injects energy (a bounce would overshoot its drop height)
            jn = (-vn + jnp.maximum(bias * cdepth, rest_pair[s])) \
                / jnp.maximum(k_n, 1e-6)
            jn = jnp.where(cmask, jnp.maximum(jn, 0.0), 0.0)
            imp = jn[:, None] * normal

            # --- friction (Coulomb clamp on the tangential relative vel) ---
            vt_rel = rel - vn[:, None] * normal
            vt_n = jnp.linalg.norm(vt_rel, axis=1)
            jt = jnp.where(cmask,
                           jnp.minimum(vt_n / jnp.maximum(k_n, 1e-6),
                                       scfg.friction * jn), 0.0)
            t_dirp = -vt_rel / jnp.maximum(vt_n, 1e-6)[:, None]
            imp_all = imp + jt[:, None] * t_dirp
            imp_sum = imp_sum + imp_all
            tau_a = tau_a + jnp.cross(ra, -imp_all)
            tau_b = tau_b + jnp.cross(rb, imp_all)

        dv = (_scatter_add_rows(imp_sum, j_idx, n)
              - _scatter_add_rows(imp_sum, i_idx, n))
        dtau = (_scatter_add_rows(tau_a, i_idx, n)
                + _scatter_add_rows(tau_b, j_idx, n))
        vel = vel + dv * inv_mass[:, None]
        angvel = angvel + jnp.einsum("nij,nj->ni", inv_iw, dtau)

        # --- ground contacts (static plane, normal +z) ---
        zhat = jnp.array([0.0, 0.0, 1.0], dtype)[None, :]
        rg = g_point - state.pos
        vg = vel + jnp.cross(angvel, rg)
        vn_g = vg[:, 2]
        k_g = inv_mass + ang_term(inv_iw, rg, jnp.broadcast_to(zhat, rg.shape))
        jg = jnp.where(g_hit,
                       jnp.maximum(-vn_g + jnp.maximum(bias * g_pen,
                                                       rest_ground), 0.0)
                       / jnp.maximum(k_g, 1e-6), 0.0)
        imp_g = jg[:, None] * zhat
        vel = vel + imp_g * inv_mass[:, None]
        angvel = angvel + jnp.einsum("nij,nj->ni", inv_iw,
                                     jnp.cross(rg, imp_g))

        # --- ground friction (tangential clamp) ---
        vt = vg.at[:, 2].set(0.0)
        vt_norm = jnp.linalg.norm(vt, axis=1)
        jt = jnp.where(g_hit, jnp.minimum(vt_norm / jnp.maximum(k_g, 1e-6),
                                          scfg.friction * jg), 0.0)
        t_dir = -vt / jnp.maximum(vt_norm, 1e-6)[:, None]
        imp_t = jt[:, None] * t_dir
        vel = vel + imp_t * inv_mass[:, None]
        angvel = angvel + jnp.einsum("nij,nj->ni", inv_iw,
                                     jnp.cross(rg, imp_t))

        return (vel, angvel), None

    (vel, angvel), _ = jax.lax.scan(solve, (vel, angvel), None,
                                    length=scfg.solver_iters)

    # ---- integrate ---------------------------------------------------------
    pos = state.pos + vel * dt
    quat = jax.vmap(quat_integrate, in_axes=(0, 0, None))(state.quat, angvel, dt)

    diag = {
        "n_candidates": n_cand,
        "candidate_overflow": bp_overflow,
        "manifold_overflow": manifold_overflow,
        "n_contacts": jnp.sum(contact.astype(jnp.int32)),
        "n_ground": jnp.sum(g_hit.astype(jnp.int32)),
        "max_depth": jnp.max(jnp.where(contact, depth, 0.0)),
    }
    return SimState(pos=pos, quat=quat, vel=vel, angvel=angvel,
                    half=state.half), diag
