"""Smoke run of the collision engine on the GPU.

    python chip_smoke.py              # one GPU: phases c1, hulls, deep, analytic, sim
    python chip_smoke.py --devices 4  # four GPUs: only the sharded pair path

One JAX process drives the card(s) and also runs the CPU backend, which is
the reference every phase compares with (the same jitted function on a
seeded sample of lanes), beside the float64 numpy oracle of
``tests/oracle_np.py``.  Inputs are float32 under ``GJKEPAConfig.for_f32()``
with x64 off, at the bench configurations' sizes (``gjkepa.utils.workloads``).

Each phase prints one JSON line: per call its shapes, compile seconds
(set-up), steady seconds (median of calls ended by ``block_until_ready``)
and ``compiled.memory_analysis()``; the device's ``peak_bytes_in_use`` so
far; and its comparison statistics.  The card's ``nvidia-smi`` name and
power limit come first.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}`` and is
printed only when every check of every phase passed; otherwise the script
exits non-zero without it.  Without a GPU it exits non-zero before any
phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

# ---- tolerances -------------------------------------------------------------
# Hit verdicts must agree, except on lanes within NEAR_TOUCH of touching
# (|depth| or |distance| below it): there a float32 rounding of one support
# dot decides the verdict, on any backend.  Such lanes are counted.
NEAR_TOUCH = 1e-4
# Against the float64 oracle: the f32 bound the golden fixtures use
# (tests/test_golden_degenerate.py, check_exact's f32_tol).
ORACLE_TOL = 2e-5
# GPU vs the same jitted f32 function on the CPU: XLA fuses and orders the
# reductions of the two backends differently, so support dots differ in
# their last bits.  EPA then may stop one expansion apart, which moves depth
# by up to its convergence tolerance, and the polish descends on a slightly
# different grid.  1e-4 is five times the oracle bound and still far below
# any geometric feature of the fixtures (>= 0.1).
CPU_TOL = 1e-4
# Two outputs are discontinuous in their inputs, so a last-bit difference
# can move a lane's answer as a whole; at most MOVED_MAX of the compared
# lanes may move by more than CPU_TOL, and they are counted:
#  * manifolds: the support polygon takes the vertices within
#    support_set_tol of the support maximum, the clip keeps points within
#    it of the reference plane, and the 4-point reduction breaks ties
#    between equally deep points.  Turning the normals by one ulp on the
#    CPU moves 0.7-1.2% of the deep fixture's lanes and 0-0.2% of the
#    hull-vs-shape ones.  A lane that does not move has the same point
#    count, and the same depths and points as sets.  Every device lane is
#    also checked on its own: finite kept points and depths, points only
#    and always on hit lanes.
#  * distance on analytic shapes: on capsule pairs the distance GJK can
#    alternate between segment ends until its iteration cap, or stop on a
#    repeated support short of the optimum, and ends on a rounding-dependent
#    iterate (ROADMAP queue 2).  A one-ulp change of the positions moves
#    0.5-0.7% of the c3 fixture's separated lanes on the CPU.
MOVED_MAX = 0.02
# One sim step from the same state: positions are pos + dt * vel, with
# velocities from gravity and a few contact impulses summed in a different
# order; the f32 ulp at the scene's |x| ~ 30 is ~4e-6.
SIM_STEP_TOL = 2e-5


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Batch sizes of the phases: the bench configurations'."""
    hull_pairs: int = 65536
    hull_verts: int = 64
    deep_pairs: int = 16384
    deep_verts: int = 24
    analytic_pairs: int = 65536
    hull_shape_pairs: int = 16384
    hull_shape_verts: int = 24
    sim_scenes: tuple = ()          # () -> workloads.SIM_1K and SIM_16K
    sample: int = 1024              # lanes compared with the CPU
    oracle: int = 128               # lanes compared with the f64 oracle
    reps: int = 5                   # timed calls per steady time


def _put(tree, dev):
    import jax

    return jax.device_put(tree, dev)


def _take(tree, idx):
    import jax

    return jax.tree_util.tree_map(lambda x: np.asarray(x)[idx], tree)


def _shapes(tree):
    import jax

    return [list(np.shape(x)) for x in jax.tree_util.tree_leaves(tree)]


def _set_dist(p, pm, q, qm):
    """Per lane, the largest distance (max-abs) from a kept point of p to
    the nearest kept point of q: (B, K, 3) points, (B, K) masks."""
    d = np.abs(p[:, :, None, :] - q[:, None, :, :]).max(-1)    # (B, K, K)
    d = np.where(qm[:, None, :], d, np.inf).min(-1)            # (B, K)
    return np.where(pm, d, 0.0).max(-1)


def _max_abs(a, b, mask):
    mask = np.asarray(mask, bool)
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))[mask])) \
        if mask.any() else 0.0


class Phase:
    """One phase's calls and checks; :meth:`finish` prints its line."""

    def __init__(self, name, dev, reps):
        self.dev, self.reps = dev, reps
        self.line = {"phase": name, "calls": {}, "checks": {}}
        self.failed = []

    def run(self, key, fn, *args):
        """Compile jitted `fn` for `args` (already on the device), time it,
        and return its device result."""
        from gjkepa.utils.harness import (compile_timed, memory_report,
                                          steady_seconds)

        compiled, t_compile = compile_timed(fn, *args)
        t_steady = steady_seconds(lambda: compiled(*args), self.reps)
        self.line["calls"][key] = {
            "shapes": _shapes(args), "compile_s": t_compile,
            "steady_s": t_steady, "memory_analysis": memory_report(compiled)}
        return compiled(*args)

    def check(self, name, ok, **stats):
        self.line["checks"][name] = dict(stats, ok=bool(ok))
        if not ok:
            self.failed.append(name)

    def verdicts(self, name, hit, hit_ref, margin):
        """Hit verdicts equal except on lanes within NEAR_TOUCH of
        touching (`margin` is the lane's |depth| or |distance|)."""
        hit, hit_ref = np.asarray(hit, bool), np.asarray(hit_ref, bool)
        diff = hit != hit_ref
        near = diff & (np.abs(np.asarray(margin)) < NEAR_TOUCH)
        self.check(name, not (diff & ~near).any(), lanes=int(hit.size),
                   hits=int(hit_ref.sum()), mismatched=int(diff.sum()),
                   near_touching=int(near.sum()))

    def manifolds(self, name, m, hit, idx, mc):
        """Device manifolds `m` of every lane (`hit` their query verdicts)
        checked on their own, and lanes `idx` of them against the CPU
        manifolds `mc` of the same inputs (see the tolerances)."""
        mask = np.asarray(m.mask, bool)
        hit = np.asarray(hit, bool)
        self.check(f"{name}_sane",
                   np.isfinite(np.where(mask[..., None], m.points, 0.0)).all()
                   and np.isfinite(np.where(mask, m.depths, 0.0)).all()
                   and (mask.any(1) == hit).all(), lanes=int(hit.size))
        mg = _take(m, idx)
        same = np.all(mg.mask == mc.mask, axis=1)
        depth_err = np.abs(np.sort(np.where(mg.mask, mg.depths, -1.0), 1)
                           - np.sort(np.where(mc.mask, mc.depths, -1.0), 1))
        dist = np.maximum(_set_dist(mg.points, mg.mask, mc.points, mc.mask),
                          _set_dist(mc.points, mc.mask, mg.points, mg.mask))
        moved = ~same | (depth_err.max(1) > CPU_TOL) | (dist > CPU_TOL)
        lanes = int(np.asarray(mc.mask).any(1).sum())
        self.check(f"{name}_cpu", moved.sum() <= MOVED_MAX * lanes,
                   lanes=lanes, moved=int(moved.sum()),
                   limit=MOVED_MAX, point_limit=CPU_TOL,
                   max_set_dist_others=float(np.max(np.where(
                       moved, 0.0, dist), initial=0.0)))

    def bound(self, name, err, limit, **stats):
        self.check(name, err <= limit, max_abs_err=err, limit=limit, **stats)

    def finish(self):
        stats = self.dev.memory_stats() or {}
        self.line["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        self.line["ok"] = not self.failed
        print(json.dumps(self.line), flush=True)
        return not self.failed


def _f32():
    from gjkepa import GJKEPAConfig

    return GJKEPAConfig.for_f32()


def _sample(rng, b, k):
    return np.sort(rng.choice(b, size=min(k, b), replace=False))


def _oracle():
    """``tests/oracle_np.py``, loaded by path: an installed package named
    ``tests`` would shadow the checkout's test directory."""
    name = "gjkepa_oracle_np"
    if name not in sys.modules:
        path = Path(__file__).resolve().parent / "tests" / "oracle_np.py"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _oracle_lanes(p1, p2, lanes):
    """(reference-semantics results, exact signed distances) of `lanes`;
    lanes where the reference would halt are None."""
    oracle = _oracle()
    refs, sd = [], []
    for i in lanes:
        a, b = p1[i].astype(np.float64), p2[i].astype(np.float64)
        try:
            refs.append(oracle.gjkepa_oracle(a, b))
        except oracle.OracleHalt:
            refs.append(None)
        sd.append(oracle.signed_distance_oracle(a, b))
    return refs, np.asarray(sd)


def phase_c1(dev, cpu, sizes):
    """c1: one cube-cube ``gjkepa``; depth 0.5 +- 1e-4."""
    import jax

    from gjkepa import gjkepa
    from gjkepa.utils.workloads import cube_pair

    ph = Phase("c1_single_pair", dev, sizes.reps)
    a, b = cube_pair()
    f = jax.jit(functools.partial(gjkepa, cfg=_f32()))
    r = jax.device_get(ph.run("gjkepa", f, *_put((a, b), dev)))
    rc = jax.device_get(f(*_put((a, b), cpu)))
    ph.check("depth_0.5", bool(r.hit) and abs(float(r.depth) - 0.5) <= 1e-4,
             depth=float(r.depth), limit=1e-4)
    ph.bound("cpu_depth", abs(float(r.depth) - float(rc.depth)), CPU_TOL)
    return ph.finish()


def phase_hulls(dev, cpu, sizes, seed=1):
    """c2: hull pairs through ``gjkepa_batch`` in boolean mode and through
    ``gjk_distance_batch``."""
    import jax

    from gjkepa import gjkepa_batch
    from gjkepa.api import gjk_distance_batch
    from gjkepa.utils.workloads import random_hulls

    ph = Phase("hulls", dev, sizes.reps)
    rng = np.random.default_rng(seed)
    b, n = sizes.hull_pairs, sizes.hull_verts
    p1, p2 = random_hulls(rng, b, n), random_hulls(rng, b, n)
    cfg = _f32()
    f_bool = jax.jit(functools.partial(gjkepa_batch,
                                       cfg=cfg.replace(epa_max_iters=0)))
    f_dist = jax.jit(functools.partial(gjk_distance_batch, cfg=cfg))
    args = _put((p1, p2), dev)
    rb = jax.device_get(ph.run("gjkepa_batch_bool", f_bool, *args))
    rd = jax.device_get(ph.run("gjk_distance_batch", f_dist, *args))
    ph.line["hit_fraction"] = float(np.mean(rb.hit))

    idx = _sample(rng, b, sizes.sample)
    s_args = _put(_take((p1, p2), idx), cpu)
    cb = jax.device_get(f_bool(*s_args))
    cd = jax.device_get(f_dist(*s_args))
    cf = jax.device_get(jax.jit(functools.partial(gjkepa_batch, cfg=cfg))(
        *s_args))
    margin = np.where(cf.hit, cf.depth, cd.distance)
    ph.verdicts("cpu_bool_verdict", rb.hit[idx], cb.hit, margin)
    ph.verdicts("cpu_intersecting", rd.intersecting[idx], cd.intersecting,
                margin)
    apart = ~rd.intersecting[idx] & ~cd.intersecting
    ph.bound("cpu_distance", _max_abs(rd.distance[idx], cd.distance, apart),
             CPU_TOL, lanes=int(apart.sum()))

    lanes = idx[:sizes.oracle]
    refs, sd = _oracle_lanes(p1, p2, lanes)
    ok = np.array([r is not None for r in refs])
    ph.verdicts("oracle_bool_verdict", rb.hit[lanes][ok],
                [r.hit for r in refs if r is not None], sd[ok])
    ph.verdicts("exact_intersecting", rd.intersecting[lanes], sd < 0, sd)
    apart = ~rd.intersecting[lanes] & (sd > 0)
    ph.bound("exact_distance", _max_abs(rd.distance[lanes], sd, apart),
             ORACLE_TOL, lanes=int(apart.sum()), halted=int((~ok).sum()))
    return ph.finish()


def phase_deep(dev, cpu, sizes, seed=2):
    """c4: deep-penetration hull pairs through ``gjkepa_batch`` (full EPA),
    then ``manifold_batch`` on its answers."""
    import jax

    from gjkepa import Status, gjkepa_batch, manifold_batch
    from gjkepa.utils.workloads import deep_pairs

    ph = Phase("deep", dev, sizes.reps)
    rng = np.random.default_rng(seed)
    b = sizes.deep_pairs
    p1, p2 = deep_pairs(rng, b, sizes.deep_verts)
    cfg = _f32()
    f = jax.jit(functools.partial(gjkepa_batch, cfg=cfg))
    r = jax.device_get(ph.run("gjkepa_batch", f, *_put((p1, p2), dev)))
    ph.line["hit_fraction"] = float(np.mean(r.hit))
    ph.line["status_counts"] = {int(s): int(c) for s, c in
                                zip(*np.unique(r.status, return_counts=True))}
    ph.line["mean_epa_iters_on_hits"] = float(np.mean(r.epa_iters[r.hit])) \
        if r.hit.any() else None
    f_m = jax.jit(functools.partial(manifold_batch, cfg=cfg))
    m_in = (p1, p2, r.normal, r.depth, r.hit, r.contact_point)
    m = jax.device_get(ph.run("manifold_batch", f_m, *_put(m_in, dev)))

    idx = _sample(rng, b, sizes.sample)
    c = jax.device_get(f(*_put(_take((p1, p2), idx), cpu)))
    ph.verdicts("cpu_verdict", r.hit[idx], c.hit,
                np.where(r.hit[idx], r.depth[idx], c.depth))
    ok = (r.status[idx] == Status.HIT) & (c.status == Status.HIT)
    ph.bound("cpu_depth", _max_abs(r.depth[idx], c.depth, ok), CPU_TOL,
             lanes=int(ok.sum()))
    ph.manifolds("manifold", m, r.hit, idx,
                 jax.device_get(f_m(*_put(_take(m_in, idx), cpu))))

    lanes = idx[:sizes.oracle]
    refs, _ = _oracle_lanes(p1, p2, lanes)
    ok = np.array([o is not None for o in refs])
    o_hit = np.array([bool(o and o.hit) for o in refs])
    o_depth = np.array([o.depth if o else 0.0 for o in refs])
    ph.verdicts("oracle_verdict", r.hit[lanes][ok], o_hit[ok],
                np.where(o_hit, o_depth, r.depth[lanes])[ok])
    exact = ok & o_hit & (r.status[lanes] == Status.HIT) \
        & ~np.array([bool(o and o.epa_capped) for o in refs])
    ph.bound("oracle_depth", _max_abs(r.depth[lanes], o_depth, exact),
             ORACLE_TOL, lanes=int(exact.sum()), halted=int((~ok).sum()))
    return ph.finish()


def phase_analytic(dev, cpu, sizes, seed=3):
    """c3 / c3b: mixed analytic pairs through ``collide_shapes_batch`` and
    ``gjk_distance_shapes_batch``; hull-vs-shape pairs through
    ``collide_hull_shape_batch``, then ``manifold_hull_shape_batch``."""
    import jax

    from gjkepa import collide_shapes_batch, manifold_hull_shape_batch
    from gjkepa.api import collide_hull_shape_batch, gjk_distance_shapes_batch
    from gjkepa.utils.workloads import analytic_pairs, hull_shape_pairs

    ph = Phase("analytic", dev, sizes.reps)
    rng = np.random.default_rng(seed)
    cfg = _f32()
    calls = (
        ("collide_shapes_batch", collide_shapes_batch,
         analytic_pairs(rng, sizes.analytic_pairs)),
        ("collide_hull_shape_batch", collide_hull_shape_batch,
         hull_shape_pairs(rng, sizes.hull_shape_pairs, sizes.hull_shape_verts)),
    )
    for key, entry, inputs in calls:
        inputs = jax.device_get(inputs)
        f = jax.jit(functools.partial(entry, cfg=cfg))
        r = jax.device_get(ph.run(key, f, *_put(inputs, dev)))
        ph.line[f"{key}_hit_fraction"] = float(np.mean(r.hit))
        idx = _sample(rng, r.hit.shape[0], sizes.sample)
        s_in = _put(_take(inputs, idx), cpu)
        c = jax.device_get(f(*s_in))
        ph.verdicts(f"{key}_cpu_verdict", r.hit[idx], c.hit,
                    np.where(r.hit[idx], r.depth[idx], c.depth))
        both = r.hit[idx] & c.hit
        ph.bound(f"{key}_cpu_depth", _max_abs(r.depth[idx], c.depth, both),
                 CPU_TOL, lanes=int(both.sum()))

        if entry is collide_shapes_batch:
            f_d = jax.jit(functools.partial(gjk_distance_shapes_batch, cfg=cfg))
            d = jax.device_get(ph.run("gjk_distance_shapes_batch", f_d,
                                      *_put(inputs, dev)))
            dc = jax.device_get(f_d(*s_in))
            ph.verdicts("distance_cpu_intersecting", d.intersecting[idx],
                        dc.intersecting, np.where(c.hit, c.depth, dc.distance))
            apart = ~d.intersecting[idx] & ~dc.intersecting
            err = np.where(apart, np.abs(d.distance[idx] - dc.distance), 0.0)
            moved = err > CPU_TOL
            ph.check("distance_cpu_distance",
                     moved.sum() <= MOVED_MAX * apart.sum(),
                     lanes=int(apart.sum()), moved=int(moved.sum()),
                     limit=MOVED_MAX, distance_limit=CPU_TOL,
                     max_abs_err=float(err.max(initial=0.0)))
        else:
            f_m = jax.jit(functools.partial(manifold_hull_shape_batch, cfg=cfg))
            m_in = (*inputs, r.normal, r.depth, r.hit, r.contact_point)
            m = jax.device_get(ph.run("manifold_hull_shape_batch", f_m,
                                      *_put(m_in, dev)))
            ph.manifolds("manifold", m, r.hit, idx,
                         jax.device_get(f_m(*_put(_take(m_in, idx), cpu))))
    return ph.finish()


def phase_sim(dev, cpu, sizes):
    """c5: ``sim_step`` on the 1,024-box scene (10 steps) and the
    16,384-box scene (3 steps).  Positions stay finite and above the floor;
    one step of the first scene matches the CPU."""
    import jax

    from gjkepa.sim.rigid import SimConfig, init_boxes, sim_step
    from gjkepa.utils.harness import compile_timed, memory_report
    from gjkepa.utils.workloads import SIM_1K, SIM_16K

    ph = Phase("sim", dev, sizes.reps)
    for k, scene in enumerate(sizes.sim_scenes or (SIM_1K, SIM_16K)):
        scfg = SimConfig(max_pairs=scene.max_pairs)
        step = jax.jit(functools.partial(sim_step, scfg=scfg))
        state = jax.device_get(init_boxes(scene.n, height=scene.height,
                                          spread=scene.spread))
        s = _put(state, dev)
        compiled, t_compile = compile_timed(step, s)
        times = []
        for i in range(scene.steps):
            t0 = time.perf_counter()
            s, diag = jax.block_until_ready(compiled(s))
            times.append(time.perf_counter() - t0)
            if i == 0 and k == 0:
                first = jax.device_get(s.pos)
        key = f"sim_step_{scene.n}"
        ph.line["calls"][key] = {
            "shapes": _shapes(s), "steps": scene.steps,
            "compile_s": t_compile, "steady_s": float(np.median(times)),
            "memory_analysis": memory_report(compiled),
            "diagnostics": {n: np.asarray(v).item()
                            for n, v in jax.device_get(diag).items()}}
        pos = np.asarray(jax.device_get(s.pos))
        ph.check(f"{key}_finite", np.isfinite(pos).all())
        ph.check(f"{key}_above_floor", pos[:, 2].min() > scfg.ground_z,
                 min_z=float(pos[:, 2].min()))
        if k == 0:
            ref, _ = step(_put(state, cpu))
            ph.bound(f"{key}_cpu_first_step",
                     _max_abs(first, jax.device_get(ref.pos),
                              np.ones(first.shape, bool)), SIM_STEP_TOL)
    return ph.finish()


def phase_sharded(devs, sizes, seed=4):
    """The pair axis sharded over ``pair_mesh(len(devs))``:
    ``gjkepa_batch_sharded`` and ``contact_count_sharded`` against the
    one-device ``gjkepa_batch`` on ``devs[0]``."""
    import jax

    from gjkepa import gjkepa_batch
    from gjkepa.parallel import (contact_count_sharded, gjkepa_batch_sharded,
                                 pair_mesh, shard_pairs)
    from gjkepa.utils.workloads import random_hulls

    ph = Phase(f"sharded_{len(devs)}", devs[0], sizes.reps)
    rng = np.random.default_rng(seed)
    b, n = sizes.hull_pairs, sizes.hull_verts
    p1, p2 = random_hulls(rng, b, n), random_hulls(rng, b, n)
    cfg = _f32()
    mesh = pair_mesh(len(devs))
    ph.check("mesh_devices", list(mesh.devices.flat) == list(devs))
    sharded = shard_pairs(mesh, p1, p2)
    rs_dev = ph.run("gjkepa_batch_sharded", jax.jit(
        lambda x, y: gjkepa_batch_sharded(mesh, x, y, cfg=cfg)), *sharded)
    ph.check("result_devices", len(rs_dev.depth.sharding.device_set)
             == len(devs), devices=len(rs_dev.depth.sharding.device_set))
    cnt = ph.run("contact_count_sharded", jax.jit(
        lambda x, y: contact_count_sharded(mesh, x, y, cfg=cfg)), *sharded)
    f = jax.jit(functools.partial(gjkepa_batch, cfg=cfg))
    ru = jax.device_get(ph.run("gjkepa_batch_one_device", f,
                               *_put((p1, p2), devs[0])))
    rs = jax.device_get(rs_dev)
    ph.check("psum_count", int(cnt) == int(ru.hit.sum()),
             psum=int(cnt), one_device=int(ru.hit.sum()))
    # shard shapes differ, so XLA may fuse differently: phase-2 tolerances
    ph.verdicts("lane_verdict", rs.hit, ru.hit,
                np.where(ru.hit, ru.depth, rs.depth))
    both = rs.hit & ru.hit
    ph.bound("lane_depth", _max_abs(rs.depth, ru.depth, both), CPU_TOL,
             lanes=int(both.sum()))
    return ph.finish()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded pair path on four GPUs")
    args = ap.parse_args(argv)

    # the CPU backend is the comparison reference, in this same process
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    import jax

    from gjkepa.utils.harness import gpu_query, require_gpu, use_compile_cache

    devs = require_gpu(args.devices)
    for line in gpu_query():
        print(line, flush=True)
    if jax.config.jax_enable_x64:
        raise SystemExit("chip_smoke runs float32 with x64 off")
    use_compile_cache()
    cpu = jax.devices("cpu")[0]
    sizes = Sizes()

    if args.devices == 1:
        phases = [functools.partial(p, devs[0], cpu, sizes) for p in
                  (phase_c1, phase_hulls, phase_deep, phase_analytic, phase_sim)]
    else:
        phases = [functools.partial(phase_sharded, devs, sizes)]
    failed = []
    for run in phases:
        name = run.func.__name__
        try:
            if not run():
                failed.append(name)
        except Exception as e:  # report every phase; exit non-zero below
            print(json.dumps({"phase": name, "ok": False,
                              "error": f"{type(e).__name__}: {e}"[:2000]}),
                  flush=True)
            failed.append(name)
    if failed:
        raise SystemExit(f"chip_smoke: failed phases: {', '.join(failed)}")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}),
        flush=True)


if __name__ == "__main__":
    main()
