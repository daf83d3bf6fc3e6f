"""Round-trip and closed-form tests for the file-path projections
(VERDICT round-1 item 7): WGS84 polar stereographic, Albers NAD83,
cylindrical, Cassini/rotated-pole, Gaussian
(module_map_utils.F90:825-1082, 1431-1658, 1901-2214).
"""

import numpy as np
import pytest

from mpassit_jax.constants import (
    PROJ_ALBERS_NAD83,
    PROJ_CASSINI,
    PROJ_CYL,
    PROJ_GAUSS,
    PROJ_PS_WGS84,
)
from mpassit_jax.grids.projection import (
    gaussian_latitudes,
    ij_to_latlon,
    latlon_to_ij,
    make_proj,
    rotate_coords,
)


def _roundtrip(proj, lat, lon, tol=1e-8):
    i, j = latlon_to_ij(proj, lat, lon)
    lat2, lon2 = ij_to_latlon(proj, i, j)
    np.testing.assert_allclose(lat2, lat, atol=tol)
    dlon = np.mod(np.asarray(lon2) - lon + 180.0, 360.0) - 180.0
    np.testing.assert_allclose(dlon, 0.0, atol=tol)


def test_ps_wgs84_roundtrip_and_refpoint():
    proj = make_proj(PROJ_PS_WGS84, truelat1=60.0, stdlon=-100.0,
                     lat1=40.0, lon1=-110.0, knowni=5.0, knownj=7.0,
                     dx=10000.0)
    # the known point must map to (knowni, knownj) exactly
    i, j = latlon_to_ij(proj, 40.0, -110.0)
    assert abs(i - 5.0) < 1e-9 and abs(j - 7.0) < 1e-9
    rng = np.random.default_rng(1)
    lat = rng.uniform(25.0, 85.0, 50)
    lon = rng.uniform(-180.0, 180.0, 50)
    # the inverse goes through a truncated conformal-latitude series;
    # the series residual is O(e^10) ~ 1e-10 deg
    _roundtrip(proj, lat, lon, tol=1e-7)


def test_ps_wgs84_southern_hemisphere():
    proj = make_proj(PROJ_PS_WGS84, truelat1=-71.0, stdlon=0.0,
                     lat1=-60.0, lon1=30.0, knowni=1.0, knownj=1.0,
                     dx=25000.0)
    rng = np.random.default_rng(2)
    lat = rng.uniform(-88.0, -30.0, 40)
    lon = rng.uniform(-180.0, 180.0, 40)
    _roundtrip(proj, lat, lon, tol=1e-7)


def test_albers_roundtrip_and_refpoint():
    # CONUS NAD83 Albers standard parallels
    proj = make_proj(PROJ_ALBERS_NAD83, truelat1=29.5, truelat2=45.5,
                     stdlon=-96.0, lat1=23.0, lon1=-96.0,
                     knowni=1.0, knownj=1.0, dx=5000.0)
    i, j = latlon_to_ij(proj, 23.0, -96.0)
    assert abs(i - 1.0) < 1e-9 and abs(j - 1.0) < 1e-9
    rng = np.random.default_rng(3)
    lat = rng.uniform(20.0, 55.0, 50)
    lon = rng.uniform(-130.0, -60.0, 50)
    _roundtrip(proj, lat, lon, tol=1e-7)


def test_albers_equal_truelats():
    proj = make_proj(PROJ_ALBERS_NAD83, truelat1=40.0, truelat2=40.0,
                     stdlon=-96.0, lat1=30.0, lon1=-100.0,
                     knowni=1.0, knownj=1.0, dx=12000.0)
    _roundtrip(proj, np.array([35.0, 45.0]), np.array([-110.0, -80.0]),
               tol=1e-7)


def test_cyl_roundtrip_and_wrap():
    proj = make_proj(PROJ_CYL, lat1=-30.0, lon1=100.0, latinc=0.5,
                     loninc=0.5, knowni=1.0, knownj=1.0)
    rng = np.random.default_rng(4)
    lat = rng.uniform(-29.0, 40.0, 40)
    lon = rng.uniform(-180.0, 180.0, 40)
    _roundtrip(proj, lat, lon, tol=1e-9)
    # one grid cell east of the anchor
    i, j = latlon_to_ij(proj, -30.0, 100.5)
    assert abs(i - 2.0) < 1e-9 and abs(j - 1.0) < 1e-9


def test_rotate_coords_inverse_pair():
    """geographic->computational (direction=-1) then computational->
    geographic (direction=+1) is the identity (rotate_coords, :1600-1658)."""
    rng = np.random.default_rng(5)
    lat = rng.uniform(-80.0, 80.0, 60)
    lon = rng.uniform(-179.0, 179.0, 60)
    lat0, lon0, stdlon = 52.0, 10.0, -20.0
    clat, clon = rotate_coords(lat, lon, lat0, lon0, stdlon, -1)
    blat, blon = rotate_coords(clat, clon, lat0, lon0, stdlon, 1)
    np.testing.assert_allclose(blat, lat, atol=1e-9)
    dlon = np.mod(blon - lon + 180.0, 360.0) - 180.0
    np.testing.assert_allclose(dlon, 0.0, atol=1e-9)


def test_rotate_coords_unrotated_pole_identity():
    """With the rotated pole at the true pole, computational == geographic
    latitude everywhere."""
    lat = np.array([-45.0, 0.0, 30.0])
    lon = np.array([10.0, -120.0, 170.0])
    olat, _ = rotate_coords(lat, lon, 90.0, 0.0, 0.0, 1)
    np.testing.assert_allclose(olat, lat, atol=1e-9)


def test_cassini_roundtrip_rotated():
    proj = make_proj(PROJ_CASSINI, lat1=-10.0, lon1=-20.0, latinc=0.25,
                     loninc=0.25, stdlon=0.0, lat0=50.0, lon0=10.0,
                     knowni=1.0, knownj=1.0)
    rng = np.random.default_rng(6)
    lat = rng.uniform(-30.0, 60.0, 40)
    lon = rng.uniform(-90.0, 90.0, 40)
    _roundtrip(proj, lat, lon, tol=1e-7)


def test_cassini_unrotated_equals_cyl():
    """lat0=90 disables the rotation: Cassini == cylindrical."""
    kw = dict(lat1=-10.0, lon1=-50.0, latinc=0.5, loninc=0.5,
              stdlon=0.0, knowni=1.0, knownj=1.0)
    pc = make_proj(PROJ_CASSINI, lat0=90.0, lon0=0.0, **kw)
    py = make_proj(PROJ_CYL, **kw)
    lat = np.array([-5.0, 10.0, 25.0])
    lon = np.array([-40.0, 0.0, 40.0])
    ic, jc = latlon_to_ij(pc, lat, lon)
    iy, jy = latlon_to_ij(py, lat, lon)
    np.testing.assert_allclose(ic, iy, atol=1e-12)
    np.testing.assert_allclose(jc, jy, atol=1e-12)


def test_gaussian_latitudes_closed_form():
    """Degree-2 Gauss-Legendre nodes are +-1/sqrt(3):
    lat = +-asin(1/sqrt(3)) = +-35.264389682754654 deg."""
    g = gaussian_latitudes(2)
    np.testing.assert_allclose(
        g, [35.264389682754654, -35.264389682754654], atol=1e-12)
    # T-grid sanity: 96 lats, symmetric, strictly decreasing from ~88.57N
    g96 = gaussian_latitudes(96)
    assert g96[0] == pytest.approx(88.57216851400088, abs=1e-6)
    np.testing.assert_allclose(g96, -g96[::-1], atol=1e-12)
    assert (np.diff(g96) < 0).all()


def test_gauss_roundtrip():
    nlat = 24                                  # 48 Gaussian rows
    glat0 = gaussian_latitudes(nlat * 2)[0]
    proj = make_proj(PROJ_GAUSS, nlat=nlat, lat1=glat0, lon1=0.0,
                     loninc=360.0 / 96, nxmax=96)
    # exact grid rows map to integer j
    glat = np.asarray(proj.gauss_lat)
    i, j = latlon_to_ij(proj, glat, np.zeros_like(glat))
    np.testing.assert_allclose(j, np.arange(1, nlat * 2 + 1), atol=1e-9)
    np.testing.assert_allclose(i, 1.0, atol=1e-9)
    # ij -> latlon -> ij round trip on fractional points
    rng = np.random.default_rng(7)
    jj = rng.uniform(1.0, nlat * 2.0, 30)
    ii = rng.uniform(1.0, 96.0, 30)
    lat, lon = ij_to_latlon(proj, ii, jj)
    i2, j2 = latlon_to_ij(proj, lat, lon)
    np.testing.assert_allclose(i2, ii, atol=1e-9)
    np.testing.assert_allclose(j2, jj, atol=1e-9)


def test_gauss_pole_clamp():
    """Poleward of the first Gaussian row the reference clamps j to the
    nearer end (llij_gauss, :2173-2184)."""
    nlat = 10
    glat0 = gaussian_latitudes(nlat * 2)[0]
    proj = make_proj(PROJ_GAUSS, nlat=nlat, lat1=glat0, lon1=0.0,
                     loninc=360.0 / 40, nxmax=40)
    _, j = latlon_to_ij(proj, np.array([89.9, -89.9]), np.array([0.0, 0.0]))
    assert j[0] == 1.0 and j[1] == float(nlat * 2)
