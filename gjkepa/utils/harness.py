"""Helpers shared by ``bench.py`` and ``chip_smoke.py``.

  * the device gate: both scripts measure the GPU and refuse to run (and
    to print a result) anywhere else;
  * the card's ``nvidia-smi`` name and power limit, which every number
    they print is labelled with;
  * the persistent compilation cache;
  * compile and steady-state timing, ended by ``block_until_ready``.

The library itself sets no cache and never looks at the device kind.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time
from pathlib import Path

__all__ = ["CACHE_ENV", "compile_cache_dir", "use_compile_cache",
           "require_gpu", "gpu_query", "compile_timed", "steady_seconds",
           "memory_report"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=None, root=None) -> tuple[str, bool]:
    """(directory, from_env): ``$JAX_COMPILATION_CACHE_DIR`` when it is set,
    else ``<root>/.jax_cache`` with `root` the checkout.  The fallback is a
    fixed path because the directory is part of what a later run must find
    again; it is never derived from a temp name, a pid or the time."""
    environ = os.environ if environ is None else environ
    env = environ.get(CACHE_ENV, "")
    if env:
        return env, True
    root = _REPO_ROOT if root is None else Path(root)
    return str(root / ".jax_cache"), False


def use_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`.  When the
    environment variable is set JAX already reads it, and nothing is set."""
    path, from_env = compile_cache_dir()
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(n_devices: int = 1):
    """The first `n_devices` JAX devices, which must be GPUs.  Anything
    else exits with a message and a non-zero code: a timing or a check
    taken on another backend is not a GPU result."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU: JAX's default backend is "
                         f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < n_devices:
        raise SystemExit(f"needs {n_devices} GPUs, JAX sees {len(devs)}")
    return devs[:n_devices]


def gpu_query() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card.
    A missing or failing ``nvidia-smi`` raises."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no GPU")
    return lines


def compile_timed(fn, *args):
    """(compiled, seconds): ahead-of-time compile of jitted `fn` for
    `args`.  Compilation is set-up time, reported apart from steady time."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def steady_seconds(call, reps: int = 5) -> float:
    """Median wall seconds of `call()` after one warm-up call, each call
    ended by ``block_until_ready`` (JAX returns before the device is done,
    so a timing without it measures the enqueue)."""
    import jax

    jax.block_until_ready(call())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def memory_report(compiled) -> dict | None:
    """The byte counts of ``compiled.memory_analysis()``, or None where the
    backend gives none."""
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
