"""Static configuration for the GJK+EPA narrow-phase engine.

The reference hard-codes its numerical contract as literals scattered through
``GCLIB_GJKEPA.f90`` (see SURVEY.md §2.2).  Here they live in one frozen
dataclass that is static under ``jax.jit`` — every field is a Python number,
so changing a field recompiles, which is exactly what we want for tolerances
and iteration caps.

Reference values (cited to /root/reference/src/GCLIB_GJKEPA.f90):
  - eps_coincide = 1e-8   (:106,123,140,157,199,203,222-223,726,741,994,1248)
  - eps_zero     = 1e-12  (:905,910,935,1301,1350,1369,1392,1404,1474)
  - support_set_tol = 0.1 (:471-472,792)  contact-point support clustering
  - broadphase_tol  = 1.0 (:1172)         bounding-sphere inflation
  - init_max_iters  = 99  (:86)
  - gjk_max_iters   = 50  (:186)
  - epa_max_iters   = 99  (:299)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GJKEPAConfig:
    """Numerical contract of a narrow-phase query (static under jit)."""

    # -- epsilon ladder (reference defaults, float64) ------------------------
    eps_coincide: float = 1e-8      # "same point" / coplanarity / convergence
    eps_zero: float = 1e-12         # degenerate normals, on-face tests
    support_set_tol: float = 0.1    # support-set clustering for contact points
    broadphase_tol: float = 1.0     # bounding-sphere slack
    face_contact_tol: float = 1.0   # TOL_FF_: face-face classification (:45)

    # -- iteration caps -------------------------------------------------------
    init_max_iters: int = 99        # init-direction retries, then give up
    gjk_max_iters: int = 50         # GJK loop cap, then non-hit
    epa_max_iters: int = 99         # EPA expansion cap, then status=EPA_CAP

    # -- EPA fixed-shape capacities (re-design; not in reference) -------------
    # The reference rebuilds a convex hull every EPA iteration
    # (GCLIB_GJKEPA.f90:920,950).  This engine instead keeps a capped
    # face/vertex array with alive masks.  Each EPA iteration adds one vertex
    # and at most (horizon size) faces; Euler gives F <= 2V - 4.
    epa_max_verts: int = 64
    epa_max_faces: int = 124        # 2 * epa_max_verts - 4

    # -- contact-point algorithm version (reference :329-340) -----------------
    # 1 = "experimental", 2 = "general", 3 = "stator-rotor special"
    version: int = 2

    def replace(self, **kw) -> "GJKEPAConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def for_f32(scale: float = 1.0) -> "GJKEPAConfig":
        """Tolerance ladder rescaled for float32 perf mode.

        float32 has ~1e-7 relative resolution; the reference's 1e-8/1e-12
        absolute ladder would never trigger, so degenerate-path detection
        needs looser thresholds.  Caps are unchanged.

        The ladder is ABSOLUTE, so it assumes scene coordinates of order 1:
        the default supports coordinate magnitudes up to ~100 (f32 rounding
        noise ~1e-7*|x| must stay well under eps_coincide=1e-5, and depth
        carries ~1e-7*|x| cancellation error).  For larger scenes pass the
        characteristic ``scale`` (e.g. 10 for coordinates up to ~1000):
        length-like tolerances scale linearly, the degenerate-normal guard
        eps_zero quadratically (it tests cross products ~ length^2).
        ``gjkepa.debug.checked_gjkepa_batch`` enforces the supported
        range at runtime.  Tested by tests/test_f32_scale.py.
        """
        # The f32 caps are part of the numerical contract: a capped EPA
        # polytope answers differently from a larger one, and the tests and
        # recorded results pin these values.
        return GJKEPAConfig(eps_coincide=1e-5 * scale,
                            eps_zero=1e-8 * scale * scale,
                            support_set_tol=0.1 * scale,
                            broadphase_tol=1.0 * scale,
                            epa_max_verts=40, epa_max_faces=80)


DEFAULT_CONFIG = GJKEPAConfig()
