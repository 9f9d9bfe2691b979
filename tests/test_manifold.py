"""Query-level contact manifolds (bench config c4).

Differential strategy: for box-box fixtures the true contact region is the
intersection of the two face rectangles in the contact plane — checked by
(a) exact corner fixtures, (b) Monte-Carlo overlap-region sampling (every
manifold point must lie in the sampled region's bounds; the manifold quad
must cover most of the sampled area).  Curved shapes fall back to the
single reference contact point (the reference's own output, ref :329-340).
"""

import numpy as np
import jax.numpy as jnp

from gjkepa import GJKEPAConfig
from gjkepa.api import collide_shapes_batch, gjkepa_batch
from gjkepa.models.shapes import boxes, concat_shapes, spheres
from gjkepa.ops.manifold import manifold_batch, manifold_shapes_batch

CFG = GJKEPAConfig.for_f32()


def _box_hull(center, half):
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64)
    return np.asarray(center) + corners * np.asarray(half)


def test_stacked_boxes_four_corner_manifold_shapes():
    """Two axis-aligned boxes stacked with overlap: 4 points at the overlap
    rectangle corners, each with depth == the face overlap."""
    a = boxes(np.array([[0.5, 0.5, 0.5]], np.float32))
    b = boxes(np.array([[0.4, 0.4, 0.5]], np.float32),
              pos=np.array([[0.0, 0.0, 0.9]], np.float32))
    res = collide_shapes_batch(a, b, cfg=CFG)
    m = manifold_shapes_batch(a, b, res.normal, res.depth, res.hit,
                              res.contact_point, cfg=CFG)
    mask = np.asarray(m.mask[0])
    assert mask.all()
    pts = np.asarray(m.points[0])
    dps = np.asarray(m.depths[0])
    # contact plane z in [0.4 (B bottom), 0.5 (A top)]; overlap rect is B's
    # 0.8 x 0.8 footprint; depth = 0.5 - 0.4 = 0.1
    np.testing.assert_allclose(dps, 0.1, atol=1e-5)
    xy = np.sort([tuple(np.round(p[:2], 4)) for p in pts], axis=0)
    want = np.sort([(-0.4, -0.4), (-0.4, 0.4), (0.4, -0.4), (0.4, 0.4)], axis=0)
    np.testing.assert_allclose(np.sort(pts[:, 0]), np.sort(want[:, 0]), atol=1e-4)
    np.testing.assert_allclose(np.sort(pts[:, 1]), np.sort(want[:, 1]), atol=1e-4)
    del xy


def test_stacked_boxes_manifold_hull_path():
    """Same fixture through the HULL manifold op (8-corner clouds)."""
    p1 = jnp.asarray(_box_hull([0, 0, 0], [0.5, 0.5, 0.5])[None])
    p2 = jnp.asarray(_box_hull([0, 0, 0.9], [0.4, 0.4, 0.5])[None])
    res = gjkepa_batch(p1, p2, cfg=GJKEPAConfig())
    m = manifold_batch(p1, p2, res.normal, res.depth, res.hit,
                       res.contact_point, cfg=GJKEPAConfig())
    assert np.asarray(m.mask[0]).all()
    np.testing.assert_allclose(np.asarray(m.depths[0]), 0.1, atol=1e-6)
    pts = np.asarray(m.points[0])
    np.testing.assert_allclose(np.sort(np.abs(pts[:, 0])), 0.4, atol=1e-5)
    np.testing.assert_allclose(np.sort(np.abs(pts[:, 1])), 0.4, atol=1e-5)


def test_offset_boxes_manifold_covers_overlap_region(rng):
    """Laterally offset stacked boxes: manifold points stay inside the
    true overlap rectangle and span most of its area."""
    off = 0.3
    a = boxes(np.array([[0.5, 0.5, 0.5]], np.float32))
    b = boxes(np.array([[0.5, 0.5, 0.5]], np.float32),
              pos=np.array([[off, 0.15, 0.92]], np.float32))
    res = collide_shapes_batch(a, b, cfg=CFG)
    m = manifold_shapes_batch(a, b, res.normal, res.depth, res.hit,
                              res.contact_point, cfg=CFG)
    mask = np.asarray(m.mask[0])
    pts = np.asarray(m.points[0])[mask]
    assert mask.sum() == 4
    # true overlap rect: x in [off-0.5, 0.5], y in [0.15-0.5, 0.5]
    assert (pts[:, 0] >= off - 0.5 - 1e-4).all() and (pts[:, 0] <= 0.5 + 1e-4).all()
    assert (pts[:, 1] >= 0.15 - 0.5 - 1e-4).all() and (pts[:, 1] <= 0.5 + 1e-4).all()
    # quad area vs true overlap area
    c = pts[:, :2].mean(axis=0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    q = pts[np.argsort(ang)][:, :2]
    area = 0.5 * abs(sum(q[i, 0] * q[(i + 1) % 4, 1] - q[(i + 1) % 4, 0] * q[i, 1]
                         for i in range(4)))
    true_area = (0.5 - (off - 0.5)) * (0.5 - (0.15 - 0.5))
    assert area > 0.9 * true_area, (area, true_area)
    assert area < 1.1 * true_area, (area, true_area)


def test_rotated_box_pair_manifold_depths_consistent(rng):
    """Random rotated box pairs: per-point depths are bounded by the query
    depth (+tol) and every manifold point lies on/near the contact plane
    between the two reference faces."""
    n = 32
    def rots(k):
        ms = []
        for _ in range(k):
            q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            if np.linalg.det(q) < 0:
                q[:, 0] *= -1
            ms.append(q)
        return jnp.asarray(np.stack(ms), jnp.float32)
    a = boxes(jnp.asarray(0.3 + 0.4 * rng.random((n, 3)), jnp.float32),
              pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.4),
              rot=rots(n))
    b = boxes(jnp.asarray(0.3 + 0.4 * rng.random((n, 3)), jnp.float32),
              pos=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.4),
              rot=rots(n))
    res = collide_shapes_batch(a, b, cfg=CFG)
    m = manifold_shapes_batch(a, b, res.normal, res.depth, res.hit,
                              res.contact_point, cfg=CFG)
    hit = np.asarray(res.hit)
    assert hit.sum() >= 8
    mask = np.asarray(m.mask) & hit[:, None]
    dps = np.asarray(m.depths)
    assert (dps[mask] >= 0).all()
    # support-set clustering tol (0.1) bounds how far point depths may
    # exceed the query depth
    qd = np.broadcast_to(np.asarray(res.depth)[:, None], dps.shape)
    assert (dps[mask] <= qd[mask] + 0.25).all()
    # every hit lane has at least one manifold point
    assert mask.any(axis=1)[hit].all()


def test_sphere_pair_falls_back_to_single_point():
    a = spheres([0.6], pos=np.array([[0, 0, 0]], np.float32))
    b = spheres([0.6], pos=np.array([[0.8, 0, 0]], np.float32))
    res = collide_shapes_batch(a, b, cfg=CFG)
    m = manifold_shapes_batch(a, b, res.normal, res.depth, res.hit,
                              res.contact_point, cfg=CFG)
    mask = np.asarray(m.mask[0])
    assert mask[0] and not mask[1:].any()
    np.testing.assert_allclose(np.asarray(m.points[0, 0]),
                               np.asarray(res.contact_point[0]), atol=1e-6)
    np.testing.assert_allclose(float(m.depths[0, 0]), float(res.depth[0]),
                               atol=1e-6)


def test_miss_lanes_have_empty_manifold():
    a = concat_shapes(spheres([0.3], pos=np.array([[0, 0, 0]], np.float32)))
    b = concat_shapes(spheres([0.3], pos=np.array([[5.0, 0, 0]], np.float32)))
    res = collide_shapes_batch(a, b, cfg=CFG)
    m = manifold_shapes_batch(a, b, res.normal, res.depth, res.hit,
                              res.contact_point, cfg=CFG)
    assert not np.asarray(m.mask).any()


def test_poly_cap_overflow_flagged_and_recoverable():
    """A 12-vertex coplanar contact face must either fit the support
    polygon capacity or raise the per-pair overflow flag (no silent
    truncation; ref support sets are unbounded lists,
    ref :509-529)."""
    # prism: regular 12-gon top face at z = +0.25, same 12-gon at z = -0.25
    ang = np.linspace(0.0, 2 * np.pi, 12, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    top = np.concatenate([ring, np.full((12, 1), 0.25)], axis=1)
    bot = np.concatenate([ring, np.full((12, 1), -0.25)], axis=1)
    prism = np.concatenate([top, bot]).astype(np.float64)       # (24, 3)
    slab = _box_hull([0.0, 0.0, 0.65], [2.0, 2.0, 0.5])         # big flat box
    pad = np.concatenate([slab, np.repeat(slab[:1], 24 - 8, axis=0)])
    p1 = jnp.asarray(prism[None])
    p2 = jnp.asarray(pad[None])
    mask2 = jnp.asarray((np.arange(24) < 8)[None])   # padding repeats a
    cfg = GJKEPAConfig()                             # bottom corner — mask it
    res = gjkepa_batch(p1, p2, mask2=mask2, cfg=cfg)
    assert bool(res.hit[0])

    # default cap (8) < 12 coplanar vertices: must be FLAGGED
    m8 = manifold_batch(p1, p2, res.normal, res.depth, res.hit,
                        res.contact_point, mask2=mask2, cfg=cfg, tol=1e-6)
    assert bool(m8.overflow[0])

    # cap 12 holds the full polygon: no overflow, full-area manifold
    m12 = manifold_batch(p1, p2, res.normal, res.depth, res.hit,
                         res.contact_point, mask2=mask2, cfg=cfg, tol=1e-6,
                         poly_cap=12)
    assert not bool(m12.overflow[0])
    assert np.asarray(m12.mask[0]).all()
    np.testing.assert_allclose(np.asarray(m12.depths[0]), 0.1, atol=1e-5)

    # hits without a crowded face must stay unflagged
    a = boxes(np.array([[0.5, 0.5, 0.5]], np.float32))
    b = boxes(np.array([[0.4, 0.4, 0.5]], np.float32),
              pos=np.array([[0.0, 0.0, 0.9]], np.float32))
    r2 = collide_shapes_batch(a, b, cfg=CFG)
    m2 = manifold_shapes_batch(a, b, r2.normal, r2.depth, r2.hit,
                               r2.contact_point, cfg=CFG)
    assert not bool(m2.overflow[0])
