"""Benchmark harness: the bench configurations c1-c6 on one GPU.

    python bench.py            # every configuration
    python bench.py c3 c2      # only these configuration prefixes

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "gpu": [...],
   "configs": {...}}

Headline metric = GJK+EPA pair queries/sec on the 64k mixed analytic-shape
batch (config c3).  Every number is labelled with the device JAX reports
and the card's ``nvidia-smi`` name and power limit.  The script exits
non-zero when JAX finds no GPU.

Timing: each program is compiled ahead of time (reported as set-up), called
once to warm up, then timed over repeated calls, each ended by
``block_until_ready``; the median is reported.  Inputs come from
``gjkepa.utils.workloads``, the same data ``chip_smoke.py`` checks.
Detail lines go to stderr.  ``GJKEPA_PROFILE=<dir>`` additionally writes a
``jax.profiler`` trace of a few steady calls per configuration.
"""

import contextlib
import functools
import json
import os
import sys

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def profile_scope(name):
    """Off by default; ``GJKEPA_PROFILE=<dir>`` captures one device trace
    per configuration under ``<dir>/<name>``."""
    d = os.environ.get("GJKEPA_PROFILE", "")
    if not d:
        yield False
        return
    import jax

    path = os.path.join(d, name)
    os.makedirs(path, exist_ok=True)
    with jax.profiler.trace(path):
        yield True
    log(f"profile: wrote {name} trace to {path}")


def measure(name, fn, *args, reps=10):
    """(compile seconds, median steady seconds, result) of jitted `fn` on
    `args`; traces a few steady calls when profiling is on."""
    import jax

    from gjkepa.utils.harness import compile_timed, steady_seconds

    compiled, t_compile = compile_timed(fn, *args)
    t = steady_seconds(lambda: compiled(*args), reps)
    with profile_scope(name) as on:
        if on:
            for _ in range(3):
                jax.block_until_ready(compiled(*args))
    log(f"{name}: compile {t_compile:.1f} s, steady {t * 1e3:.3f} ms")
    return t_compile, t, compiled(*args)


def main():
    # `python bench.py c3 c2` times only those configuration prefixes
    only = {a for a in sys.argv[1:] if a.startswith("c")}
    want = lambda tag: (not only) or tag in only  # noqa: E731

    import jax
    import jax.numpy as jnp

    from gjkepa import (GJKEPAConfig, collide_shapes_batch, gjkepa,
                        gjkepa_batch, manifold_batch)
    from gjkepa.api import collide_hull_shape_batch, gjk_distance_batch
    from gjkepa.utils import workloads as wl
    from gjkepa.utils.harness import gpu_query, require_gpu, use_compile_cache

    dev = require_gpu()[0]
    gpu = gpu_query()
    use_compile_cache()
    log(f"device: {dev.device_kind} ({dev.platform}) x {len(jax.devices())}; "
        f"nvidia-smi: {gpu}")
    cfg = GJKEPAConfig.for_f32()
    rng = np.random.default_rng(0)
    results = {}
    put = lambda *xs: jax.device_put(xs, dev)  # noqa: E731

    # ---- c1: single pair cube-vs-cube (latency) ---------------------------
    if want("c1"):
        f = jax.jit(functools.partial(gjkepa, cfg=cfg))
        tc, t, r = measure("c1_single_pair", f, *put(*wl.cube_pair()), reps=50)
        assert bool(r.hit) and abs(float(r.depth) - 0.5) < 1e-4, (
            float(r.depth), int(r.status))
        results["c1_single_pair_latency_us"] = t * 1e6
        results["c1_compile_s"] = tc

    # ---- c2: hull pairs, boolean + distance --------------------------------
    if want("c2"):
        f_bool = jax.jit(functools.partial(
            gjkepa_batch, cfg=cfg.replace(epa_max_iters=0)))
        f_dist = jax.jit(functools.partial(gjk_distance_batch, cfg=cfg))
        for tag, b in (("hull4k", 4096), ("hull64k", 65536)):
            args = put(wl.random_hulls(rng, b, 64), wl.random_hulls(rng, b, 64))
            _, t_bool, _ = measure(f"c2_{tag}_bool", f_bool, *args)
            _, t_dist, _ = measure(f"c2_{tag}_dist", f_dist, *args)
            results[f"c2_{tag}_bool_qps"] = b / t_bool
            results[f"c2_{tag}_dist_qps"] = b / t_dist

    # ---- c3: 64k mixed analytic pairs (HEADLINE) ---------------------------
    # median over 3 seeds: the cylinder-rim EPA tail moves with the seed
    f3 = jax.jit(functools.partial(collide_shapes_batch, cfg=cfg))
    b3 = 65536
    if want("c3"):
        qps = []
        for seed in (0, 1, 2):
            a, b = wl.analytic_pairs(np.random.default_rng(seed), b3)
            _, t3, r3 = measure(f"c3_analytic64k_seed{seed}", f3, *put(a, b))
            qps.append(b3 / t3)
            results[f"c3_seed{seed}_qps"] = b3 / t3
            results[f"c3_seed{seed}_hits"] = int(jnp.sum(r3.hit))
        results["c3_analytic64k_qps"] = float(np.median(qps))
        results["c3_seed_spread"] = (max(qps) - min(qps)) / max(qps)

        # same pairs in a shuffled caller order
        srng = np.random.default_rng(0)
        a, b = wl.analytic_pairs(srng, b3)
        perm = srng.permutation(b3)
        a, b = (jax.tree_util.tree_map(lambda x: x[perm], s) for s in (a, b))
        _, t3s, _ = measure("c3_shuffled", f3, *put(a, b))
        results["c3_shuffled_qps"] = b3 / t3s

    # ---- c3b: mixed hull-vs-analytic-shape pairs ---------------------------
    if want("c3b") or want("c3"):
        hulls, shapes = wl.hull_shape_pairs(rng, 16384, 24)
        f = jax.jit(functools.partial(collide_hull_shape_batch, cfg=cfg))
        _, t, _ = measure("c3b_mixed16k", f, *put(hulls, shapes))
        results["c3_mixed_hull_shape_qps"] = 16384 / t

    # ---- c4: 16k deep-penetration pairs, full EPA, then manifolds ----------
    big, small = wl.deep_pairs(rng, 16384, 24)
    f4 = jax.jit(functools.partial(gjkepa_batch, cfg=cfg))
    if want("c4"):
        _, t4, r4 = measure("c4_deep16k", f4, *put(big, small))
        results["c4_deep16k_qps"] = 16384 / t4
        results["c4_hit_fraction"] = float(jnp.mean(r4.hit.astype(jnp.float32)))
        results["c4_mean_epa_iters"] = float(
            jnp.mean(r4.epa_iters.astype(jnp.float32)))

        @jax.jit
        def deep_manifolds(a4, b4):
            r = gjkepa_batch(a4, b4, cfg=cfg)
            return manifold_batch(a4, b4, r.normal, r.depth, r.hit,
                                  r.contact_point, cfg=cfg)

        _, t4m, m4 = measure("c4_manifold", deep_manifolds, *put(big, small))
        results["c4_manifold_qps"] = 16384 / t4m
        results["c4_points_per_hit"] = float(jnp.sum(m4.mask)) / max(
            float(jnp.sum(r4.hit)), 1.0)

    # ---- c6: the c4 query sharded over every visible GPU -------------------
    if want("c6"):
        from gjkepa.parallel import gjkepa_batch_sharded, pair_mesh, shard_pairs

        mesh = pair_mesh()
        f6 = jax.jit(lambda x, y: gjkepa_batch_sharded(mesh, x, y, cfg=cfg))
        _, t6, _ = measure("c6_sharded", f6, *shard_pairs(mesh, big, small))
        results["c6_sharded_qps"] = 16384 / t6
        results["c6_n_devices"] = int(mesh.devices.size)

    # ---- c5: mini-sim, 1,024 and 16,384 falling boxes -----------------------
    if want("c5"):
        from gjkepa.sim.rigid import SimConfig, init_boxes, sim_step

        for scene in (wl.SIM_1K, wl.SIM_16K):
            step = jax.jit(functools.partial(
                sim_step, scfg=SimConfig(max_pairs=scene.max_pairs)))
            state = jax.device_put(init_boxes(scene.n, height=scene.height,
                                              spread=scene.spread), dev)
            _, t5, _ = measure(f"c5_sim{scene.n}", step, state,
                               reps=scene.steps)
            results[f"c5_sim{scene.n}_steps_per_sec"] = 1.0 / t5

    headline = results.get("c3_analytic64k_qps", 0.0)
    print(json.dumps({
        "metric": "gjkepa_pair_queries_per_sec_64k_batch",
        "value": headline,
        "unit": "queries/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu,
        "configs": results,
    }), flush=True)


if __name__ == "__main__":
    main()
