"""target_grid_type='file' round-trip + non-Lambert end-to-end pipelines.

The 'file' path (model_grid.F90:1203-1888) reads the grid from a
wrfout-style file; our own writer output qualifies, which gives a clean
round-trip: params-grid run -> use its output as the target file -> the
second run must land on identical coordinates.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mpassit_jax.config import Config
from mpassit_jax.grids.target import build_target_grid, target_grid_from_file
from mpassit_jax.io.nc4 import open_dataset
from mpassit_jax.run.pipeline import run_pipeline

from test_pipeline import make_case


def test_file_target_roundtrip(tmp_path):
    mesh, cfg, hist_fields, diag_fields = make_case(tmp_path, nx=16, ny=12)
    art1 = run_pipeline(cfg, dtype=jnp.float64)

    cfg2 = Config.from_dict({
        "grid_file_input_grid": cfg.grid_file_input_grid,
        "diag_file_input_grid": cfg.diag_file_input_grid,
        "hist_file_input_grid": cfg.hist_file_input_grid,
        "output_file": str(tmp_path / "out2.nc"),
        "interp_diag": True, "interp_hist": True, "wrf_mod_vars": True,
        "target_grid_type": "file",
        "file_target_grid": cfg.output_file,
        "varlist_dir": str(tmp_path),
    })
    art2 = run_pipeline(cfg2, dtype=jnp.float64)

    g1, g2 = art1.grid, art2.grid
    assert (g2.nx, g2.ny) == (g1.nx, g1.ny)
    # coords come back through f32 file storage
    np.testing.assert_allclose(g2.lat, g1.lat, atol=1e-4)
    np.testing.assert_allclose(g2.lon_u, g1.lon_u, atol=1e-4)
    np.testing.assert_allclose(g2.mapfac_v, g1.mapfac_v, atol=1e-5)
    np.testing.assert_allclose(g2.sina, g1.sina, atol=1e-5)
    # cfg back-filled from file attrs (reference mutates program_setup vars)
    assert cfg2.proj_code == 1
    assert cfg2.truelat1 == pytest.approx(38.5)
    assert cfg2.map_proj_char == "Lambert Conformal"
    # corner approximation (quirk Q10) — great-circle offset differs from the
    # exact projected corner by a small fraction of dx (here dx=200 km ~ 1.8deg)
    assert abs(g2.lat_corner[0, 0] - g1.lat_corner[0, 0]) < 0.25

    # identical weights on identical coords -> identical field values
    with open_dataset(cfg.output_file) as f1, open_dataset(cfg2.output_file) as f2:
        np.testing.assert_allclose(f1.read_var("T2"), f2.read_var("T2"),
                                   rtol=1e-5)
        # second run's HGT is regridded 'ter' again (reference overwrites
        # the file HGT when interp_hist, interp.F90:226-238)
        np.testing.assert_allclose(f1.read_var("HGT"), f2.read_var("HGT"),
                                   rtol=1e-5)


@pytest.mark.parametrize("proj,extra", [
    ("mercator", {"truelat1": 20.0}),
    ("polar", {"truelat1": 60.0}),
    ("lat-lon", {"is_regional": True}),
])
def test_non_lambert_pipelines(tmp_path, proj, extra):
    mesh, cfg, hist_fields, diag_fields = make_case(
        tmp_path, nx=15, ny=11, wrf_mod_vars=False)
    d = {
        "grid_file_input_grid": cfg.grid_file_input_grid,
        "diag_file_input_grid": cfg.diag_file_input_grid,
        "hist_file_input_grid": cfg.hist_file_input_grid,
        "output_file": str(tmp_path / f"out_{proj}.nc"),
        "interp_diag": True, "interp_hist": True,
        "target_grid_type": proj,
        "nx": 16, "ny": 12,
        "ref_lat": 38.5, "ref_lon": -97.5, "stand_lon": -97.5,
        "varlist_dir": str(tmp_path),
    }
    if proj == "lat-lon":
        d.update({"dx": 2.0, "dy": 2.0})      # degrees for lat-lon
    else:
        d.update({"dx": 250e3, "dy": 250e3})
    d.update(extra)
    cfg2 = Config.from_dict(d)
    art = run_pipeline(cfg2, dtype=jnp.float64)

    with open_dataset(cfg2.output_file) as f:
        assert f.get_attr("MAP_PROJ") == cfg2.proj_code
        # no rotation vars off-Lambert (write_data.F90:447-477)
        assert not f.has_var("SINALPHA")
        t2 = f.read_var("T2")[0]
        lat, lon = art.grid.lat, art.grid.lon
        ref = 280.0 + 5 * np.sin(np.deg2rad(lat)) * np.cos(np.deg2rad(lon))
        np.testing.assert_allclose(t2, ref, atol=0.2)
        # winds present but NOT rotated off-Lambert (interp.F90:291-293)
        u = f.read_var("U")[0]
        assert abs(u[0, :, 1:-1].mean() - 15.0) < 1.0


def test_latlon_global_grid():
    """Quirk Q9: global lat-lon grid derivation."""
    cfg = Config.from_dict({
        "target_grid_type": "lat-lon", "nx": 37, "ny": 19,
        "is_regional": False, "stand_lon": 0.0,
    })
    g = build_target_grid(cfg)
    assert g.lat.shape == (18, 36)
    assert cfg.dlondeg == pytest.approx(10.0)
    # cells centered at -90 + dlat/2 (program_setup.F90:195-211)
    assert g.lat[0, 0] == pytest.approx(-85.0)
    assert g.lat[-1, 0] == pytest.approx(85.0)
    # longitudes start at stand_lon + dlon/2
    assert g.lon[0, 0] == pytest.approx(5.0)
