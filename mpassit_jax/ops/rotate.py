"""Earth-relative -> grid-relative wind rotation for Lambert grids.

Replaces ``rotate_winds_cgrid`` (interp.F90:689-749), applied when both wind
components were interpolated and proj is Lambert (interp.F90:138-140,
291-293).

Quirk Q4 is preserved exactly: the reference rotates u IN PLACE first and
then computes v from the ALREADY-ROTATED u (interp.F90:741-745):

    tana = sina/cosa
    u' = (u + v*tana) / (cosa + sina*tana)
    v' = (v - u'*sina) / cosa          # <- u', not u

In EXACT arithmetic the sequential form reduces to the rotation matrix
(u' = u*cosa + v*sina; v' = v*cosa - u*sina — substitute and simplify), so
"sequential vs matrix" is purely a floating-point distinction: the
intermediate divisions amplify rounding by ~1/cosa^2 as |alpha| -> 90 deg,
and at cosa == 0 they divide by zero (the reference's Fortran does the
identical division, interp.F90:741-745, so parity REQUIRES reproducing
it). ``check_rotation_angles`` is the host-side guard: Lambert grids whose
corners rotate past ~84 deg (|cosa| < 0.1) get a loud warning before the
apply. Measured error growth is pinned in tests/test_rotate_extreme.py
(register row R11).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp

log = logging.getLogger("mpassit_jax")

#: |cosa| below this (|alpha| > ~84 deg) warns: the Q4 divisions amplify
#: f32 rounding by ~1/cosa^2 (see module docstring / register R11)
COSA_WARN = 0.1


def check_rotation_angles(cosa, name="target grid") -> float:
    """Host-side degeneracy guard for the Q4 rotation: returns min |cosa|
    and warns when any grid point's rotation angle approaches 90 deg,
    where the reference formula's divisions lose precision (and hit 0/0
    at exactly 90)."""
    import numpy as np

    m = float(np.abs(np.asarray(cosa)).min())
    if m < COSA_WARN:
        log.warning(
            "- WARNING: %s rotation angles reach |cosa|=%.3g "
            "(|alpha| > %.1f deg); the Q4 wind-rotation divisions amplify "
            "f32 rounding by ~1/cosa^2 there (parity register R11)",
            name, m, float(np.degrees(np.arccos(min(m, 1.0)))))
    return m


@jax.jit
def rotate_winds(u, v, cosa, sina):
    """u, v: (ny, nx) or (ny, nx, nz); cosa/sina: (ny, nx).

    Returns (u_rot, v_rot) with the reference's sequential update order."""
    if u.ndim == 3:
        cosa = cosa[:, :, None]
        sina = sina[:, :, None]
    tana = sina / cosa
    u_new = (u + v * tana) / (cosa + sina * tana)
    v_new = (v - u_new * sina) / cosa
    return u_new, v_new
