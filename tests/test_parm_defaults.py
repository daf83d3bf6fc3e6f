"""The shipped parm/ default varlists drive a full pipeline run.

Mirrors the reference's default runtime data (parm/diaglist 19 vars,
histlist_2d 6, histlist_3d 15, histlist_soil 3 — SURVEY §2.1 row 15) and
checks that every mapped output variable lands in the file with the right
dims and interpolation routing.
"""

import os
import shutil

import numpy as np
import jax.numpy as jnp

from mpassit_jax.config import Config
from mpassit_jax.fields.registry import (
    CONS_VARS,
    NSTD_VARS,
    NZP1_VARS,
    VERT_VARS,
    read_varlist,
)
from mpassit_jax.io.nc4 import open_dataset
from mpassit_jax.mesh.synthetic import (
    synthetic_voronoi_mesh,
    write_mpas_data_file,
    write_mpas_grid_file,
)
from mpassit_jax.run.pipeline import run_pipeline

PARM = os.path.join(os.path.dirname(__file__), "..", "parm")


def test_parm_lists_parse():
    diag = read_varlist(os.path.join(PARM, "diaglist"))
    h2 = read_varlist(os.path.join(PARM, "histlist_2d"))
    h3 = read_varlist(os.path.join(PARM, "histlist_3d"))
    soil = read_varlist(os.path.join(PARM, "histlist_soil"))
    assert len(diag) == 19 and len(h2) == 6 and len(h3) == 15 and len(soil) == 3
    by_in = {s.in_name: s.out_name for s in diag + h2 + h3 + soil}
    # spot-check mappings cited in SURVEY §2.1 row 15
    assert by_in["refl10cm"] == "REFL_10CM"
    assert by_in["theta"] == "T"
    assert by_in["zgrid"] == "PHB"
    assert by_in["pressure"] == "P_HYD"
    assert by_in["rho"] == "MUB"
    assert by_in["tslb"] == "TSLB"


def test_pipeline_with_parm_defaults(tmp_path):
    mesh = synthetic_voronoi_mesh(ncells=1200, nz=3, nsoil=2, seed=5)
    write_mpas_grid_file(mesh, str(tmp_path / "grid.nc"))
    for f in ("diaglist", "histlist_2d", "histlist_3d", "histlist_soil"):
        shutil.copy(os.path.join(PARM, f), tmp_path / f)

    rng = np.random.default_rng(0)
    diag = read_varlist(os.path.join(PARM, "diaglist"))
    h2 = read_varlist(os.path.join(PARM, "histlist_2d"))
    h3 = read_varlist(os.path.join(PARM, "histlist_3d"))
    soil = read_varlist(os.path.join(PARM, "histlist_soil"))

    def make(name):
        # the reference treats refl10cm* diag vars as 3-D on nz levels
        # (input_data.F90:283-292); hist routing per registry lists
        if name.startswith("refl10cm"):
            return rng.standard_normal((mesh.ncells, mesh.nz))
        return rng.standard_normal(mesh.ncells)

    diag_fields = {s.in_name: make(s.in_name) for s in diag}
    hist_fields = {}
    for s in h2:
        hist_fields[s.in_name] = np.abs(rng.standard_normal(mesh.ncells))
    for s in h3:
        nlev = mesh.nzp1 if s.in_name in NZP1_VARS else mesh.nz
        if s.in_name in VERT_VARS:
            hist_fields[s.in_name] = rng.standard_normal(
                (mesh.nvertices, mesh.nz))
        else:
            hist_fields[s.in_name] = rng.standard_normal((mesh.ncells, nlev))
    for s in soil:
        hist_fields[s.in_name] = rng.standard_normal((mesh.ncells, mesh.nsoil))

    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 30.0,
             "config_lsm_scheme": "noah", "config_microp_scheme": "mp_thompson",
             "config_convection_scheme": "cu_ntiedke"}
    write_mpas_data_file(mesh, str(tmp_path / "diag.nc"), diag_fields,
                         attrs={**attrs, "output_interval": 15},
                         xtime="2024-03-25_10:00:00")
    write_mpas_data_file(mesh, str(tmp_path / "hist.nc"), hist_fields,
                         attrs=attrs, xtime="2024-03-25_10:00:00")

    cfg = Config.from_dict({
        "grid_file_input_grid": str(tmp_path / "grid.nc"),
        "diag_file_input_grid": str(tmp_path / "diag.nc"),
        "hist_file_input_grid": str(tmp_path / "hist.nc"),
        "output_file": str(tmp_path / "out.nc"),
        "interp_diag": True, "interp_hist": True, "wrf_mod_vars": True,
        "target_grid_type": "lambert",
        "nx": 21, "ny": 17, "dx": 250e3, "dy": 250e3,
        "ref_lat": 38.5, "ref_lon": -97.5, "truelat1": 38.5,
        "stand_lon": -97.5, "varlist_dir": str(tmp_path),
    })
    run_pipeline(cfg, dtype=jnp.float64)

    with open_dataset(cfg.output_file) as f:
        # every mapped output name present (u/v become staggered U/V)
        for s in diag + h2 + h3 + soil:
            assert f.has_var(s.out_name), s.out_name
        assert f.read_var("U").shape == (1, mesh.nz, 16, 21)
        assert f.read_var("V").shape == (1, mesh.nz, 17, 20)
        assert f.read_var("PHB").shape == (1, mesh.nzp1, 16, 20)
        assert f.read_var("TSLB").shape == (1, mesh.nsoil, 16, 20)
        # wrf_mod extras all exist
        for v in ("MU", "P_TOP", "PH", "P", "PB"):
            assert f.has_var(v), v
