"""Error-message parity for bad inputs (VERDICT round-1 item 10).

The reference fails fast through error_handler/netcdf_err
(utils.F90:16-58) with specific operator-facing messages; these tests pin
our messages to the same wording instead of raw reader/KeyError traces.
"""

import numpy as np
import pytest

from mpassit_jax.config import Config, ConfigError
from mpassit_jax.errors import FatalError, NetCDFError
from mpassit_jax.fields.registry import read_varlist
from mpassit_jax.grids.target import target_grid_from_file
from mpassit_jax.mesh.mpas import mesh_from_file
from mpassit_jax.mesh.synthetic import (
    synthetic_voronoi_mesh,
    write_mpas_data_file,
    write_mpas_grid_file,
)
from mpassit_jax.run.pipeline import run_pipeline

from test_pipeline import make_case


def test_missing_varlist_file(tmp_path):
    # input_data.F90:1162
    with pytest.raises(FatalError, match="VARLIST FILE .* not exist"):
        read_varlist(str(tmp_path / "diaglist"))


def test_bad_varlist_line(tmp_path):
    p = tmp_path / "diaglist"
    p.write_text("loneword\n")
    with pytest.raises(FatalError, match="READING VARLIST FILE"):
        read_varlist(str(p))


def test_missing_grid_file(tmp_path):
    # model_grid.F90:288
    with pytest.raises(FatalError, match="OPENING MPAS INPUT FILE"):
        mesh_from_file(str(tmp_path / "nope.nc"))


def test_grid_file_missing_dim(tmp_path):
    # model_grid.F90:293: 'reading nCells id'
    from mpassit_jax.io.nc4 import NetCDF4File

    p = str(tmp_path / "empty.nc")
    with NetCDF4File(p, "w"):
        pass
    with pytest.raises(NetCDFError, match="reading nCells id"):
        mesh_from_file(p)


def test_missing_target_file(tmp_path):
    # model_grid.F90:1231
    with pytest.raises(FatalError, match="OPENING WRF INPUT FILE"):
        target_grid_from_file(str(tmp_path / "nope_wrf.nc"))


def test_target_file_missing_vars(tmp_path):
    # model_grid.F90:1364+: 'reading <var> id'
    from mpassit_jax.io.nc4 import NetCDF4File

    p = str(tmp_path / "wrf.nc")
    with NetCDF4File(p, "w") as f:
        f.create_dim("west_east", 4)
        f.create_dim("south_north", 3)
        f.set_attr("DX", 1000.0)
        f.set_attr("MAP_PROJ", 1)
    with pytest.raises(NetCDFError, match="reading XLAT id"):
        target_grid_from_file(p)


def test_varlist_var_absent_from_file(tmp_path):
    # input_data.F90:184: 'reading field id - <vname>'
    mesh, cfg, _, _ = make_case(tmp_path, ncells=400, nx=9, ny=7)
    (tmp_path / "diaglist").write_text("no_such_var\tNSV\n")
    with pytest.raises(NetCDFError,
                       match="reading field id - no_such_var: "
                             "NetCDF: Variable not found"):
        run_pipeline(cfg)


def test_hist_missing_start_time(tmp_path):
    # input_data.F90:359: 'reading config_start_time'
    mesh = synthetic_voronoi_mesh(ncells=300, nz=3, nsoil=2, seed=5)
    write_mpas_grid_file(mesh, str(tmp_path / "grid.nc"))
    write_mpas_data_file(mesh, str(tmp_path / "hist.nc"),
                         {"skintemp": np.zeros(mesh.ncells)},
                         attrs={}, xtime="2024-03-25_10:00:00")
    for n, body in (("histlist_2d", "skintemp\tTSK\n"), ("histlist_3d", ""),
                    ("histlist_soil", "")):
        (tmp_path / n).write_text(body)
    cfg = Config.from_dict({
        "grid_file_input_grid": str(tmp_path / "grid.nc"),
        "hist_file_input_grid": str(tmp_path / "hist.nc"),
        "output_file": str(tmp_path / "out.nc"),
        "interp_hist": True, "target_grid_type": "lambert",
        "nx": 8, "ny": 6, "dx": 500e3, "dy": 500e3,
        "ref_lat": 38.5, "ref_lon": -97.5, "truelat1": 38.5,
        "stand_lon": -97.5, "varlist_dir": str(tmp_path),
    })
    with pytest.raises(NetCDFError, match="reading config_start_time"):
        run_pipeline(cfg)


def test_mesh_size_mismatch(tmp_path):
    """A hist file built on a different mesh must abort, not misindex."""
    mesh, cfg, _, _ = make_case(tmp_path, ncells=400, nx=9, ny=7)
    other = synthetic_voronoi_mesh(ncells=200, nz=4, nsoil=2, seed=8)
    write_mpas_grid_file(other, str(tmp_path / "grid2.nc"))
    cfg.grid_file_input_grid = str(tmp_path / "grid2.nc")
    with pytest.raises(FatalError, match="CELLS BUT THE MPAS GRID FILE"):
        run_pipeline(cfg)


def test_nan_guard(tmp_path, monkeypatch):
    """MPASSIT_DEBUG_NANS=1 traps non-finite regridded fields (the
    reference debug-build -ffpe-trap analog, CMakeLists.txt:36)."""
    import jax.numpy as jnp

    mesh, cfg, _, _ = make_case(tmp_path, ncells=400, nx=9, ny=7,
                                interp_hist=False, wrf_mod_vars=False)
    # poison one diag input field (edited in place through the repo's
    # classic-format writer)
    from mpassit_jax.io.nc4 import ClassicFile

    with ClassicFile(cfg.diag_file_input_grid, "r+") as f:
        # poison every cell so any mapped target hits it
        f.var_view("t2m")[...] = np.nan
    monkeypatch.setenv("MPASSIT_DEBUG_NANS", "1")
    # either trap is acceptable: jax_debug_nans fires inside the jitted
    # apply (FloatingPointError), the host guard fires after (FatalError)
    with pytest.raises((FatalError, FloatingPointError),
                       match="NON-FINITE VALUES|nan"):
        run_pipeline(cfg, dtype=jnp.float64)
    monkeypatch.delenv("MPASSIT_DEBUG_NANS")
    # without the flag the run completes (quirk Q5 spirit: garbage passes)
    import jax

    jax.config.update("jax_debug_nans", False)
    run_pipeline(cfg, dtype=jnp.float64)


def test_config_error_is_fatal():
    assert issubclass(ConfigError, FatalError)
    with pytest.raises(FatalError, match="invalid target_grid_type"):
        Config.from_dict({"target_grid_type": "bogus", "nx": 4, "ny": 4})


def test_cli_banner_and_exit_code(tmp_path, capsys):
    """main() prints the error_handler banner and exits like mpi_abort."""
    from mpassit_jax.run.pipeline import main

    nml = tmp_path / "namelist.input"
    nml.write_text("&config\n target_grid_type = 'bogus'\n nx=4\n ny=4\n/\n")
    rc = main([str(nml)])
    assert rc == 999 & 0xFF
    err = capsys.readouterr().err
    assert "FATAL ERROR" in err
    assert "invalid target_grid_type" in err
