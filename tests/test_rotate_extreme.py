"""Q4 wind rotation at large rotation angles (VERDICT r3 item 7,
register row R11).

The reference's sequential update (interp.F90:741-745) is ALGEBRAICALLY
the exact rotation matrix — substituting u' into the v line gives
u' = u*cosa + v*sina, v' = v*cosa - u*sina. The difference is purely
floating point: tana = sina/cosa and the two divisions amplify rounding
by ~1/cosa^2 as |alpha| -> 90 deg. These tests pin (a) the exact-math
equivalence, (b) the measured f32 error-growth bound, (c) the documented
0/0 behavior at exactly 90 deg, and (d) the pipeline's host-side warning.
"""

import logging

import numpy as np
import pytest

from mpassit_jax.ops.rotate import (
    COSA_WARN,
    check_rotation_angles,
    rotate_winds,
)


def _matrix_truth(u, v, cosa, sina):
    return u * cosa + v * sina, v * cosa - u * sina


def test_sequential_equals_matrix_in_f64():
    """In f64 at moderate angles the sequential form matches the matrix
    form to rounding — they are the same map."""
    rng = np.random.default_rng(0)
    alpha = np.deg2rad(rng.uniform(-45, 45, size=(40, 50)))
    cosa, sina = np.cos(alpha), np.sin(alpha)
    u = rng.standard_normal((40, 50)) * 30
    v = rng.standard_normal((40, 50)) * 30
    ur, vr = rotate_winds(u, v, cosa, sina)
    ut, vt = _matrix_truth(u, v, cosa, sina)
    np.testing.assert_allclose(np.asarray(ur), ut, rtol=0, atol=1e-12 * 30)
    np.testing.assert_allclose(np.asarray(vr), vt, rtol=0, atol=1e-12 * 30)


@pytest.mark.parametrize("alpha_deg,bound", [
    (60.0, 1e-6), (80.0, 1e-5), (89.0, 3e-4), (89.9, 3e-2)])
def test_f32_error_growth_bound(alpha_deg, bound):
    """Measured R11 bound: f32 sequential-form error vs the f64 matrix
    truth grows ~1/cosa^2 (cosa^-2 * 2^-23 ~ the observed envelope).
    CONUS-class grids (|alpha| < ~35 deg) sit at the 1e-7 floor; only
    corners rotated past ~89 deg lose more than 4 significant digits."""
    rng = np.random.default_rng(1)
    a = np.full((8, 8), np.deg2rad(alpha_deg))
    cosa32 = np.cos(a).astype(np.float32)
    sina32 = np.sin(a).astype(np.float32)
    u = (rng.standard_normal((8, 8)) * 30).astype(np.float32)
    v = (rng.standard_normal((8, 8)) * 30).astype(np.float32)
    ur, vr = rotate_winds(u, v, cosa32, sina32)
    ut, vt = _matrix_truth(u.astype(np.float64), v.astype(np.float64),
                           np.cos(a), np.sin(a))
    scale = np.abs(u).max() + np.abs(v).max()
    err = max(np.abs(np.asarray(ur, np.float64) - ut).max(),
              np.abs(np.asarray(vr, np.float64) - vt).max()) / scale
    assert err < bound, (alpha_deg, err, bound)


def test_exactly_90_degrees_is_nonfinite():
    """cosa == 0: the reference divides by zero (interp.F90:745); parity
    means we do too — the result is non-finite, never silently wrong."""
    u = np.ones((2, 2), np.float32)
    v = np.ones((2, 2), np.float32)
    ur, vr = rotate_winds(u, v, np.zeros((2, 2), np.float32),
                          np.ones((2, 2), np.float32))
    assert not np.isfinite(np.asarray(vr)).all()


def test_check_rotation_angles_warns(caplog):
    cosa = np.array([[1.0, 0.5], [0.05, 0.9]])
    with caplog.at_level(logging.WARNING, logger="mpassit_jax"):
        m = check_rotation_angles(cosa, name="unit test grid")
    assert m == pytest.approx(0.05)
    assert any("R11" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="mpassit_jax"):
        m = check_rotation_angles(np.full((3, 3), 0.8))
    assert m == pytest.approx(0.8) and not caplog.records
    assert COSA_WARN == 0.1
