"""Convex-hull preprocessing (the GCLIB_QuickHull / GCLIB_DeHull capability).

The reference presumes a convex-hull builder and a face-soup deduplicator
from its private GCLIB library (imports at
``/root/reference/src/GCLIB_GJKEPA.f90:13-15``; modules absent from the
repo, SURVEY.md §2.3).  The engine's query path never rebuilds hulls
(incremental EPA), so these are host-side preprocessing ops:

  * :func:`convex_hull` / :func:`convex_hull_batch` — point cloud ->
    triangle faces + extreme-vertex indices, backed by the native C++
    QuickHull (``native/quickhull.cpp``, built on demand) with a
    scipy.spatial fallback;
  * :func:`hull_vertices` — the extreme subset of a cloud (what the query
    API actually needs: interior points only waste support-scan lanes);
  * :func:`dedup_vertices` — face soup -> unique vertex list
    (getHullMeshesVertex's contract);
  * :func:`pad_hulls` — ragged hull list -> padded (B, N, 3) + mask batch
    for :func:`gjkepa.gjkepa_batch`.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = [
    "convex_hull",
    "convex_hull_batch",
    "hull_vertices",
    "dedup_vertices",
    "pad_hulls",
    "native_available",
]

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libquickhull.so"
_lib = None
_lib_failed = False


def _load_native():
    """Build (if needed) and load the C++ QuickHull library."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR)],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.qh_convex_hull.restype = ctypes.c_int
        lib.qh_convex_hull.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.qh_convex_hull_batch.restype = ctypes.c_int
        lib.qh_convex_hull_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    except Exception as e:  # build tools or compiler missing
        print(f"[gjkepa] native quickhull unavailable ({e}); "
              "falling back to scipy", file=sys.stderr)
        _lib_failed = True
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _hull_native(points: np.ndarray):
    lib = _load_native()
    n = points.shape[0]
    max_faces = max(4, 2 * n)
    pts = np.ascontiguousarray(points, dtype=np.float64)
    faces = np.empty((max_faces, 3), np.int32)
    verts = np.empty((n,), np.int32)
    nf = np.zeros(1, np.int32)
    nv = np.zeros(1, np.int32)
    rc = lib.qh_convex_hull(_f64p(pts), n, _i32p(faces), max_faces, _i32p(nf),
                            _i32p(verts), n, _i32p(nv))
    if rc != 0:
        raise ValueError(f"qh_convex_hull failed (rc={rc}): degenerate input?")
    return faces[: int(nf[0])].copy(), verts[: int(nv[0])].copy()


def _hull_scipy(points: np.ndarray):
    from scipy.spatial import ConvexHull

    h = ConvexHull(points, qhull_options="Qt")
    return h.simplices.astype(np.int32), h.vertices.astype(np.int32)


def convex_hull(points: np.ndarray, backend: str = "auto"):
    """3-D convex hull: (faces (F,3) int32 vertex indices, vert_idx (V,))."""
    points = np.asarray(points, dtype=np.float64)
    if backend == "native" or (backend == "auto" and native_available()):
        return _hull_native(points)
    return _hull_scipy(points)


def convex_hull_batch(points: np.ndarray, backend: str = "auto"):
    """Batch hulls: points (B,N,3) -> list of (faces, vert_idx) per cloud."""
    points = np.asarray(points, dtype=np.float64)
    b, n = points.shape[0], points.shape[1]
    if backend == "native" or (backend == "auto" and native_available()):
        lib = _load_native()
        max_faces = max(4, 2 * n)
        pts = np.ascontiguousarray(points)
        faces = np.empty((b, max_faces, 3), np.int32)
        verts = np.empty((b, n), np.int32)
        nf = np.zeros(b, np.int32)
        nv = np.zeros(b, np.int32)
        fails = lib.qh_convex_hull_batch(
            _f64p(pts), b, n, _i32p(faces), max_faces, _i32p(nf),
            _i32p(verts), n, _i32p(nv))
        if fails:
            raise ValueError(f"{fails} clouds failed convex_hull_batch")
        return [(faces[i, : nf[i]].copy(), verts[i, : nv[i]].copy())
                for i in range(b)]
    return [_hull_scipy(points[i]) for i in range(b)]


def hull_vertices(points: np.ndarray, backend: str = "auto") -> np.ndarray:
    """The extreme subset of a cloud (interior points stripped)."""
    _, idx = convex_hull(points, backend)
    return np.asarray(points, dtype=np.float64)[idx]


def dedup_vertices(face_soup: np.ndarray, tol: float = 0.0) -> np.ndarray:
    """Face soup (F,3,3) -> unique vertex list (getHullMeshesVertex, ref :920)."""
    pts = np.asarray(face_soup, dtype=np.float64).reshape(-1, 3)
    if tol <= 0:
        return np.unique(pts, axis=0)
    scaled = np.round(pts / tol).astype(np.int64)
    _, idx = np.unique(scaled, axis=0, return_index=True)
    return pts[np.sort(idx)]


def pad_hulls(hulls, pad_to: int | None = None, dtype=np.float32):
    """Ragged list of (Ni,3) vertex arrays -> padded (B,N,3) + (B,N) mask.

    Padding repeats each hull's first vertex, so the padded buffer is still
    the same convex set even if a mask is not supplied to the query.
    """
    sizes = [len(h) for h in hulls]
    n = pad_to or max(sizes)
    if max(sizes) > n:
        raise ValueError(f"pad_to={n} smaller than largest hull ({max(sizes)})")
    b = len(hulls)
    out = np.empty((b, n, 3), dtype=dtype)
    mask = np.zeros((b, n), dtype=bool)
    for i, h in enumerate(hulls):
        k = len(h)
        out[i, :k] = h
        out[i, k:] = h[0]
        mask[i, :k] = True
    return out, mask
