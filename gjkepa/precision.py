"""Full float32 precision for every contraction of a traced entry point.

On the GPU a float32 ``dot_general`` whose precision is left at DEFAULT may
run in TF32, which keeps about 10 bits of mantissa.  The engine moves data
with one-hot contractions (support-point selection in every GJK/EPA
iteration, the EPA face tables, the manifold clipper) and takes its
per-pair dot products under ``vmap`` as batched contractions, so TF32 would
put a ~1e-3 relative error into every depth, normal and witness point.

:func:`highest_precision` scopes ``jax.default_matmul_precision("highest")``
to the trace of one function.  It is applied to the public entry points
only; nothing is set globally at import.  On the CPU the setting changes
nothing.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["highest_precision"]


def highest_precision(fn):
    """Decorate `fn` so that its trace runs under HIGHEST matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
