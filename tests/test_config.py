import math

import pytest

from mpassit_jax.config import Config, ConfigError, parse_namelist
from mpassit_jax.constants import EARTH_RADIUS_M, NAN, PROJ_LATLON, PROJ_LC

CONUS_NML = """
&config
 grid_file_input_grid = "grid.nc"
 hist_file_input_grid = "hist.nc"
 diag_file_input_grid = "diag.nc"
 output_file = "out.nc"
 interp_diag = .true.
 interp_hist = .true.
 wrf_mod_vars = .true.
 esmf_log = .false.
 nx = 1802            ! staggered dims, README.md:64-67
 ny = 1062
 dx = 3000.0
 dy = 3000.0
 ref_lat = 38.5
 ref_lon = -97.5
 truelat1 = 38.5
 stand_lon = -97.5
 target_grid_type = 'lambert'
/
"""


def test_parse_namelist_basics():
    g = parse_namelist(CONUS_NML)
    cfg = g["config"]
    assert cfg["nx"] == 1802
    assert cfg["dx"] == 3000.0
    assert cfg["interp_diag"] is True
    assert cfg["esmf_log"] is False
    assert cfg["target_grid_type"] == "lambert"
    assert cfg["grid_file_input_grid"] == "grid.nc"


def test_lambert_derivation():
    cfg = Config.from_dict(parse_namelist(CONUS_NML)["config"])
    # program_setup.F90:163-164 — mass dims are nx-1, ny-1
    assert cfg.i_target == 1801 and cfg.j_target == 1061
    assert cfg.proj_code == PROJ_LC
    assert cfg.map_proj_char == "Lambert Conformal"
    # truelat2 defaults to truelat1 (program_setup.F90:232-235)
    assert cfg.truelat2 == 38.5
    # ref point defaults to domain center (program_setup.F90:238-244)
    assert cfg.known_x == 1802 / 2.0
    assert cfg.known_y == 1062 / 2.0
    assert cfg.dxkm == 3000.0


def test_latlon_global_derivation():
    nml = {
        "target_grid_type": "lat-lon",
        "nx": 361,
        "ny": 181,
        "stand_lon": 0.0,
        "is_regional": False,
    }
    cfg = Config.from_dict(nml)
    assert cfg.proj_code == PROJ_LATLON
    # program_setup.F90:203-210 (quirk Q9)
    assert cfg.dlondeg == 1.0
    assert cfg.dlatdeg == 1.0
    assert cfg.known_x == 1.0 and cfg.known_y == 1.0
    assert cfg.known_lon == 0.5
    assert cfg.known_lat == -89.5
    assert math.isclose(cfg.dxkm, EARTH_RADIUS_M * math.pi * 2.0 / 360)


def test_latlon_global_regional_conflict():
    with pytest.raises(ConfigError):
        Config.from_dict({"target_grid_type": "lat-lon", "nx": 10, "ny": 10,
                          "stand_lon": 0.0, "is_regional": True})


def test_latlon_regional_needs_ref():
    with pytest.raises(ConfigError):
        Config.from_dict({"target_grid_type": "lat-lon", "nx": 10, "ny": 10,
                          "dx": 0.5, "dy": 0.5, "is_regional": True})


def test_bad_projection_rejected():
    with pytest.raises(ConfigError):
        Config.from_dict({"target_grid_type": "stereo", "nx": 5, "ny": 5})


def test_lambert_requires_truelat1():
    with pytest.raises(ConfigError):
        Config.from_dict({"target_grid_type": "lambert", "nx": 5, "ny": 5,
                          "dx": 1000.0, "dy": 1000.0})


def test_ref_xy_one_sided_error():
    with pytest.raises(ConfigError):
        Config.from_dict({"target_grid_type": "lambert", "nx": 5, "ny": 5,
                          "dx": 1000.0, "dy": 1000.0, "truelat1": 30.0,
                          "stand_lon": 0.0, "ref_lat": 30.0, "ref_lon": 0.0,
                          "ref_x": 2.0})
