"""The main path imports no h5py: classic-format inputs and the CDF-2
output need only numpy. A NetCDF4/HDF5 input without h5py is a clean
FatalError that names the package."""

import os
import subprocess
import sys

import pytest

from mpassit_jax.errors import FatalError

from test_pipeline import make_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pipeline_runs_with_h5py_blocked(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from mpassit_jax.io.nc4 import open_dataset
    from mpassit_jax.run.pipeline import run_pipeline

    monkeypatch.setitem(sys.modules, "h5py", None)   # import h5py fails
    mesh, cfg, _, _ = make_case(tmp_path, ncells=400, nx=9, ny=7)
    cfg.stream_output = True
    run_pipeline(cfg, dtype=jnp.float32)
    with open_dataset(cfg.output_file) as f:
        assert f.version == 2 and "T" in f.var_names()


def test_cli_never_imports_h5py(tmp_path):
    """A fresh interpreter runs the CLI on classic inputs with h5py made
    unimportable; the run succeeds and h5py was never loaded."""
    mesh, cfg, _, _ = make_case(tmp_path, ncells=400, nx=9, ny=7)
    nml = tmp_path / "namelist.input"
    nml.write_text(f"""&config
 grid_file_input_grid = "{cfg.grid_file_input_grid}"
 diag_file_input_grid = "{cfg.diag_file_input_grid}"
 hist_file_input_grid = "{cfg.hist_file_input_grid}"
 output_file = "{tmp_path / 'cli_out.nc'}"
 interp_diag = .true.
 interp_hist = .true.
 wrf_mod_vars = .true.
 target_grid_type = 'lambert'
 nx = {cfg.i_target + 1}
 ny = {cfg.j_target + 1}
 dx = {cfg.dx}
 dy = {cfg.dy}
 ref_lat = 38.5
 ref_lon = -97.5
 truelat1 = 38.5
 stand_lon = -97.5
 varlist_dir = "{cfg.varlist_dir}"
/
""")
    code = ("import sys; sys.modules['h5py'] = None; "
            "from mpassit_jax.run.pipeline import main; rc = main([sys.argv[1]]); "
            "assert sys.modules['h5py'] is None; sys.exit(rc)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code, str(nml)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert os.path.exists(tmp_path / "cli_out.nc")


def test_netcdf4_input_without_h5py_is_fatal(tmp_path, monkeypatch):
    from mpassit_jax.io.nc4 import NetCDF4File, open_dataset
    from mpassit_jax.mesh.mpas import mesh_from_file

    pytest.importorskip("h5py")
    p = str(tmp_path / "grid4.nc")
    with NetCDF4File(p, "w") as f:
        f.create_dim("nCells", 3)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(FatalError, match="h5py"):
        open_dataset(p)
    with pytest.raises(FatalError, match="h5py"):
        mesh_from_file(p)
