"""L4 broadphase: bounding-sphere reject + uniform-grid pair generation.

The reference's only broadphase is a centroid + max-radius bounding-sphere
guard with a fixed 1.0 inflation
(RoughCollisionDetection_SphericalEnvelope,
``/root/reference/src/GCLIB_GJKEPA.f90:1165-1188``).  The uniform grid is a
capability extension used by the rigid-body mini-sim (bench config c5) to
generate fixed-capacity candidate pair lists on-device.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["sphere_envelope_overlap", "bounding_spheres",
           "grid_candidate_pairs", "swept_candidate_pairs"]


def _masked_mean(p, mask):
    if mask is None:
        return jnp.mean(p, axis=0)
    cnt = jnp.maximum(jnp.sum(mask), 1).astype(p.dtype)
    return jnp.sum(jnp.where(mask[:, None], p, 0.0), axis=0) / cnt


def bounding_spheres(p, mask=None):
    """Centroid + max-radius bounding sphere of a vertex cloud (ref :1174-1182)."""
    c = _masked_mean(p, mask)
    d = jnp.linalg.norm(p - c, axis=1)
    if mask is not None:
        d = jnp.where(mask, d, 0.0)
    return c, jnp.max(d)


def sphere_envelope_overlap(p1, p2, mask1=None, mask2=None, tol: float = 1.0):
    """Reject if ||c1-c2|| > r1 + r2 + TOL, TOL=1.0 (ref :1172,1185)."""
    c1, r1 = bounding_spheres(p1, mask1)
    c2, r2 = bounding_spheres(p2, mask2)
    return jnp.linalg.norm(c1 - c2) <= r1 + r2 + tol


def grid_candidate_pairs(centers, radii, cell_size: float, max_pairs: int):
    """Broadphase candidate-pair generation over body bounding spheres.

    Emits up to `max_pairs` candidate (i, j) pairs (j > i) whose inflated
    spheres overlap, as a fixed-shape (<= max_pairs, 2) int32 buffer +
    validity mask; also returns the true candidate count so callers can
    detect overflow (pairs beyond the per-row budget are dropped).

    For sim-scale n (O(1k) bodies) this is an O(n^2) masked sweep compacted
    ROW-WISE with cumsums: each body i gets up to K = max_pairs // n pair
    slots, and the k-th candidate j in row i is located arithmetically
    (count of prefix-cumsum entries < k+1).  Everything is 2-D vector work —
    no argsort, no gathers, no global sort-based compaction of the n^2/2
    candidate mask.
    `cell_size` inflates the acceptance radius the way a one-cell grid
    neighborhood would, so narrowphase sees the same candidate set a
    classic uniform grid produces.
    """
    n = centers.shape[0]
    k_cap = max(1, max_pairs // n)
    dist = jnp.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    rsum = radii[:, None] + radii[None, :]
    upper = jnp.arange(n)[None, :] > jnp.arange(n)[:, None]
    cand = upper & (dist <= rsum + cell_size)                    # (n, n)
    cum = jnp.cumsum(cand.astype(jnp.int32), axis=1)             # per-row
    nrow = cum[:, -1]                                            # (n,)
    cols = []
    for k in range(k_cap):
        # column of the k-th (0-based) candidate in each row
        cols.append(jnp.sum((cum < k + 1).astype(jnp.int32), axis=1))
    jj = jnp.stack(cols, axis=1)                                  # (n, K)
    jj = jnp.minimum(jj, n - 1)
    ii = jnp.broadcast_to(jnp.arange(n)[:, None], (n, k_cap))
    valid = jnp.arange(k_cap)[None, :] < nrow[:, None]            # (n, K)
    pairs = jnp.stack([ii.reshape(-1), jj.reshape(-1)], axis=1).astype(jnp.int32)
    return pairs, valid.reshape(-1), jnp.sum(cand)


def swept_candidate_pairs(centers, radii, max_pairs: int, window: int = 64,
                          inflate: float = 0.5):
    """Sub-quadratic broadphase: sweep-and-prune over sorted x-intervals.

    Bodies are sorted by the lower end of their (inflated) x-interval; each
    body is tested only against its next `window` neighbors in sorted order
    (every overlapping pair appears once, as (earlier, later)).  Cost is
    O(n log n + n*window) versus grid_candidate_pairs' O(n^2) masked sweep
    — at 16k bodies that is ~256x fewer sphere tests, and all fixed-shape
    (one argsort + (n, window) vector work), so it jits into the same
    single-program sim step.

    Candidate admission is identical to grid_candidate_pairs
    (||ci-cj|| <= ri + rj + inflate), so the two produce the SAME pair set
    whenever neither overflows — pinned by tests/test_broadphase.py.

    Returns (pairs (max_pairs, 2) int32, valid mask, n_candidates,
    overflow).  `overflow` is True when candidates may have been DROPPED:
    (a) some body's x-interval extends past its window-th sorted neighbor
    (window overflow), or (b) a body found more candidates than its
    max_pairs//n row slots (row overflow), or (c) n_candidates > max_pairs.
    Callers must surface it — silently losing contacts makes piles melt
    (a pile then sinks into itself).
    """
    n = centers.shape[0]
    w = min(window, n - 1)
    k_cap = max(1, max_pairs // n)
    x = centers[:, 0]
    x_lo = x - radii
    order = jnp.argsort(x_lo)
    xs = x_lo[order]
    xe = (x + radii)[order] + inflate
    c_s = centers[order]
    r_s = radii[order]

    offs = jnp.arange(1, w + 1)
    idx = jnp.arange(n)[:, None] + offs[None, :]              # (n, w) sorted
    in_range = idx < n
    # neighbor blocks via static ROLLS, not a (n, w, 3) dynamic gather:
    # roll k gives row i its (i+k)-th sorted neighbor
    cn = jnp.stack([jnp.roll(c_s, -k, axis=0) for k in range(1, w + 1)],
                   axis=1)                                    # (n, w, 3)
    rn = jnp.stack([jnp.roll(r_s, -k) for k in range(1, w + 1)], axis=1)
    xsn = jnp.stack([jnp.roll(xs, -k) for k in range(1, w + 1)], axis=1)
    x_open = xsn <= xe[:, None]              # neighbor starts before I end
    dist = jnp.linalg.norm(cn - c_s[:, None, :], axis=-1)
    cand = in_range & x_open & (dist <= r_s[:, None] + rn + inflate)

    # window overflow: body i's interval still reaches its (i+w)-th sorted
    # neighbor's start — candidates beyond the window could exist
    tail = jnp.arange(n) + w
    tail_exists = tail < n
    over_window = jnp.any(tail_exists
                          & (xs[jnp.minimum(tail, n - 1)] <= xe))

    cum = jnp.cumsum(cand.astype(jnp.int32), axis=1)
    nrow = cum[:, -1]
    cols = [jnp.sum((cum < k + 1).astype(jnp.int32), axis=1)
            for k in range(k_cap)]
    kk = jnp.minimum(jnp.stack(cols, axis=1), w - 1)          # (n, k_cap)
    j_sorted = jnp.minimum(jnp.arange(n)[:, None] + kk + 1, n - 1)
    ii = jnp.broadcast_to(order[:, None], (n, k_cap))
    jj = order[j_sorted]
    valid = jnp.arange(k_cap)[None, :] < nrow[:, None]
    jj = jnp.where(valid, jj, ii)            # self-pair on invalid slots
    n_cand = jnp.sum(cand, dtype=jnp.int32)
    overflow = (over_window | jnp.any(nrow > k_cap)
                | (n_cand > max_pairs))
    pairs = jnp.stack([ii.reshape(-1), jj.reshape(-1)], axis=1).astype(jnp.int32)
    return pairs, valid.reshape(-1), n_cand, overflow
