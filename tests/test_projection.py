import numpy as np
import pytest

from mpassit_jax.config import Config
from mpassit_jax.constants import PROJ_LATLON, PROJ_LC, PROJ_MERC, PROJ_PS
from mpassit_jax.grids import projection as P


def conus_proj():
    return P.make_proj(
        PROJ_LC, truelat1=38.5, truelat2=38.5, stdlon=-97.5,
        lat1=38.5, lon1=-97.5, knowni=901.0, knownj=531.0, dx=3000.0,
    )


def test_lc_known_point_roundtrip():
    proj = conus_proj()
    lat, lon = P.ij_to_latlon(proj, 901.0, 531.0)
    assert np.allclose([lat, lon], [38.5, -97.5], atol=1e-9)
    i, j = P.latlon_to_ij(proj, 38.5, -97.5)
    assert np.allclose([i, j], [901.0, 531.0], atol=1e-6)


def test_lc_roundtrip_grid():
    proj = conus_proj()
    ii, jj = np.meshgrid(np.linspace(1, 1801, 41), np.linspace(1, 1061, 31))
    lat, lon = P.ij_to_latlon(proj, ii, jj)
    i2, j2 = P.latlon_to_ij(proj, lat, lon)
    assert np.allclose(i2, ii, atol=1e-6)
    assert np.allclose(j2, jj, atol=1e-6)


def test_lc_cone_tangent_and_secant():
    assert np.isclose(P.lc_cone(38.5, 38.5), np.sin(np.deg2rad(38.5)))
    # secant cone factor is between sin(lat1) and sin(lat2)
    c = P.lc_cone(30.0, 60.0)
    assert np.sin(np.deg2rad(30.0)) < c < np.sin(np.deg2rad(60.0))


def test_lc_southern_hemisphere():
    proj = P.make_proj(PROJ_LC, truelat1=-33.0, truelat2=-45.0, stdlon=147.0,
                       lat1=-40.0, lon1=147.0, knowni=50.0, knownj=50.0, dx=12000.0)
    lat, lon = P.ij_to_latlon(proj, 50.0, 50.0)
    assert np.allclose([lat, lon], [-40.0, 147.0], atol=1e-6)
    lat2, lon2 = P.ij_to_latlon(proj, 60.0, 50.0)
    assert lon2 > 147.0  # +i is east


def test_ps_roundtrip():
    proj = P.make_proj(PROJ_PS, truelat1=60.0, stdlon=-150.0,
                       lat1=64.0, lon1=-150.0, knowni=100.0, knownj=100.0,
                       dx=10000.0)
    lat, lon = P.ij_to_latlon(proj, 100.0, 100.0)
    assert np.allclose([lat, lon], [64.0, -150.0], atol=1e-7)
    ii, jj = np.meshgrid(np.arange(1, 200, 13.0), np.arange(1, 200, 17.0))
    lat, lon = P.ij_to_latlon(proj, ii, jj)
    i2, j2 = P.latlon_to_ij(proj, lat, lon)
    assert np.allclose(i2, ii, atol=1e-6) and np.allclose(j2, jj, atol=1e-6)


def test_merc_roundtrip():
    proj = P.make_proj(PROJ_MERC, truelat1=20.0, lat1=10.0, lon1=120.0,
                       knowni=50.0, knownj=40.0, dx=15000.0)
    lat, lon = P.ij_to_latlon(proj, 50.0, 40.0)
    assert np.allclose([lat, lon], [10.0, 120.0], atol=1e-7)
    ii, jj = np.meshgrid(np.arange(1, 100, 7.0), np.arange(1, 80, 5.0))
    lat, lon = P.ij_to_latlon(proj, ii, jj)
    i2, j2 = P.latlon_to_ij(proj, lat, lon)
    assert np.allclose(i2, ii, atol=1e-6) and np.allclose(j2, jj, atol=1e-6)


def test_latlon_global():
    cfg = Config.from_dict({"target_grid_type": "lat-lon", "nx": 361, "ny": 181,
                            "stand_lon": 0.0, "is_regional": False})
    proj = P.proj_from_config(cfg)
    lat, lon = P.ij_to_latlon(proj, 1.0, 1.0)
    assert np.allclose([lat, lon], [-89.5, 0.5])
    lat, lon = P.ij_to_latlon(proj, 360.0, 180.0)
    assert np.allclose([lat, lon], [89.5, 359.5])


def test_stagger_offsets():
    proj = conus_proj()
    lat_m, lon_m = P.stagger_latlon(proj, 4, 3, P.M)
    lat_u, lon_u = P.stagger_latlon(proj, 5, 3, P.U)
    lat_v, lon_v = P.stagger_latlon(proj, 4, 4, P.V)
    lat_c, lon_c = P.stagger_latlon(proj, 5, 4, P.CORNER)
    assert lat_m.shape == (3, 4)
    assert lat_u.shape == (3, 5)
    assert lat_v.shape == (4, 4)
    assert lat_c.shape == (4, 5)
    # U point i is mass point i shifted half a cell west:
    latu_direct, lonu_direct = P.ij_to_latlon(proj, 1 - 0.5, 1.0)
    assert np.allclose([lat_u[0, 0], lon_u[0, 0]], [latu_direct, lonu_direct])
    # interior U point lies midway (in x) between adjacent mass points
    i_m0, _ = P.latlon_to_ij(proj, lat_m[0, 0], lon_m[0, 0])
    i_u1, _ = P.latlon_to_ij(proj, lat_u[0, 1], lon_u[0, 1])
    assert np.isclose(i_u1 - i_m0, 0.5, atol=1e-9)


def test_map_factor_lc_at_truelat_is_one():
    proj = conus_proj()
    mx, my = P.map_factor(proj, np.array([38.5]))
    assert np.allclose(mx, 1.0, atol=1e-12)
    # secant projection: 1 at both true lats, < 1 between
    proj2 = P.make_proj(PROJ_LC, truelat1=30.0, truelat2=60.0, stdlon=-97.5,
                        lat1=45.0, lon1=-97.5, knowni=1.0, knownj=1.0, dx=3000.0)
    mx, _ = P.map_factor(proj2, np.array([30.0, 45.0, 60.0]))
    assert np.allclose(mx[[0, 2]], 1.0, atol=1e-10)
    assert mx[1] < 1.0


def test_map_factor_ps_merc():
    projp = P.make_proj(PROJ_PS, truelat1=60.0, stdlon=0.0, lat1=60.0,
                        lon1=0.0, knowni=1.0, knownj=1.0, dx=5000.0)
    mx, _ = P.map_factor(projp, np.array([60.0]))
    assert np.allclose(mx, 1.0)
    projm = P.make_proj(PROJ_MERC, truelat1=20.0, lat1=0.0, lon1=0.0,
                        knowni=1.0, knownj=1.0, dx=5000.0)
    mx, _ = P.map_factor(projm, np.array([20.0]))
    assert np.allclose(mx, 1.0)


def test_rotation_angle_zero_on_stdlon():
    """Along the standard longitude of an LC grid, grid north == true north."""
    proj = conus_proj()
    lat, lon = P.stagger_latlon(proj, 1801, 1061, P.M)
    cosa, sina = P.rotation_angle(lat, lon)
    mid = 900  # i index on the stand_lon column (1-based 901)
    assert np.allclose(sina[:, mid], 0.0, atol=1e-4)
    assert np.allclose(cosa[:, mid], 1.0, atol=1e-6)
    # east of stand_lon, grid north tilts: sina has consistent sign
    assert (sina[:, 1400] > 0).all() or (sina[:, 1400] < 0).all()
