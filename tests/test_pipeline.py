"""End-to-end pipeline tests on synthetic MPAS inputs (BASELINE configs 1-4)."""

import numpy as np
import pytest

from mpassit_jax.config import Config
from mpassit_jax.io.nc4 import open_dataset
from mpassit_jax.mesh.synthetic import (
    synthetic_voronoi_mesh,
    write_mpas_data_file,
    write_mpas_grid_file,
)
from mpassit_jax.run.pipeline import run_pipeline

import jax.numpy as jnp

DIAGLIST = """\
u10\tU10
v10\tV10
t2m\tT2
refl10cm\tREFL_10CM
"""
HISTLIST_2D = """\
snow\tSNOW
xland\tXLAND
skintemp\tTSK
"""
HISTLIST_3D = """\
theta\tT
zgrid\tPHB
w\tW
vorticity\tVORT
pressure\tP_HYD
rho\tMUB
uReconstructZonal\tU
uReconstructMeridional\tV
"""
HISTLIST_SOIL = """\
tslb\tTSLB
smois\tSMOIS
"""


def smooth(lat, lon, k=1.0):
    return np.sin(np.deg2rad(lat) * k) * np.cos(np.deg2rad(lon) * k)


def make_case(tmp_path, ncells=1500, nz=4, nsoil=2, wrf_mod_vars=True,
              interp_diag=True, interp_hist=True, nx=25, ny=19, dx=200e3,
              cfg_overrides=None):
    mesh = synthetic_voronoi_mesh(ncells=ncells, nz=nz, nsoil=nsoil, seed=7)
    d = tmp_path
    write_mpas_grid_file(mesh, str(d / "grid.nc"))

    zlev = np.linspace(0, 1, nz)
    zlevp1 = np.linspace(0, 1, nz + 1)
    f2 = smooth(mesh.lat_cell, mesh.lon_cell)

    def f3(levs):
        return f2[:, None] + levs[None, :]

    diag_fields = {
        "u10": 10.0 + f2, "v10": -2.0 + f2, "t2m": 280.0 + 5 * f2,
        "refl10cm": 20.0 + f3(zlev),
    }
    hist_fields = {
        "snow": np.maximum(0.0, 100.0 * f2),
        "xland": np.where(mesh.lat_cell > 0, 1.0, 2.0),
        "skintemp": 285.0 + 5 * f2,
        "theta": 300.0 + 10.0 * f3(zlev),
        "zgrid": 100.0 + 1000.0 * f3(zlevp1),
        "w": 0.1 * f3(zlevp1),
        "vorticity": 1e-4 * (smooth(mesh.lat_vertex, mesh.lon_vertex)[:, None]
                             + zlev[None, :]),
        "pressure": 100000.0 * (1.0 - 0.8 * f3(zlev) / f3(zlev).max()) + 20000,
        "rho": 1.0 + 0.1 * f3(zlev),
        "uReconstructZonal": 15.0 + f3(zlev),
        "uReconstructMeridional": -5.0 + f3(zlev),
        "tslb": 275.0 + f3(np.linspace(0, 1, nsoil)),
        "smois": 0.3 + 0.1 * f3(np.linspace(0, 1, nsoil)),
    }
    attrs = {
        "config_start_time": "2024-03-25_09:00:00",
        "config_dt": 60.0,
        "config_lsm_scheme": "noah",
        "config_microp_scheme": "mp_thompson",
        "config_convection_scheme": "cu_ntiedke",
    }
    write_mpas_data_file(mesh, str(d / "diag.nc"), diag_fields,
                         attrs={**attrs, "output_interval": 15},
                         xtime="2024-03-25_10:00:00")
    write_mpas_data_file(mesh, str(d / "hist.nc"), hist_fields, attrs=attrs,
                         xtime="2024-03-25_10:00:00")

    (d / "diaglist").write_text(DIAGLIST)
    (d / "histlist_2d").write_text(HISTLIST_2D)
    (d / "histlist_3d").write_text(HISTLIST_3D)
    (d / "histlist_soil").write_text(HISTLIST_SOIL)

    cfg_dict = {
        "grid_file_input_grid": str(d / "grid.nc"),
        "diag_file_input_grid": str(d / "diag.nc"),
        "hist_file_input_grid": str(d / "hist.nc"),
        "output_file": str(d / "out.nc"),
        "interp_diag": interp_diag,
        "interp_hist": interp_hist,
        "wrf_mod_vars": wrf_mod_vars,
        "target_grid_type": "lambert",
        "nx": nx + 1, "ny": ny + 1, "dx": dx, "dy": dx,
        "ref_lat": 38.5, "ref_lon": -97.5,
        "truelat1": 38.5, "stand_lon": -97.5,
        "varlist_dir": str(d),
    }
    if cfg_overrides:
        cfg_dict.update(cfg_overrides)
        for k, v in list(cfg_dict.items()):
            if v is None:
                del cfg_dict[k]
    cfg = Config.from_dict(cfg_dict)
    return mesh, cfg, hist_fields, diag_fields


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    mesh, cfg, hist_fields, diag_fields = make_case(d)
    art = run_pipeline(cfg, dtype=jnp.float64)
    return mesh, cfg, art, hist_fields, diag_fields


def test_output_dims_and_attrs(full_run):
    mesh, cfg, art, _, _ = full_run
    with open_dataset(cfg.output_file) as f:
        assert f.dim_size("west_east") == 25
        assert f.dim_size("west_east_stag") == 26
        assert f.dim_size("south_north") == 19
        assert f.dim_size("bottom_top") == mesh.nz
        assert f.dim_size("bottom_top_stag") == mesh.nz + 1
        assert f.dim_size("soil_layers_stag") == mesh.nsoil
        assert f.dim_size("StrLen") == 19
        assert f.get_attr("WEST-EAST_GRID_DIMENSION") == 26
        assert f.get_attr("MAP_PROJ") == 1
        assert f.get_attr("MAP_PROJ_CHAR") == "Lambert Conformal"
        assert f.get_attr("DX") == 200e3
        assert f.get_attr("DY") == 200e3   # written from DX (reference quirk)
        assert f.get_attr("SF_SURFACE_PHYSICS") == 2
        assert f.get_attr("MP_PHYSICS") == 8
        assert f.get_attr("CU_PHYSICS") == 16
        assert f.get_attr("TRUELAT2") == 38.5
        assert f.get_attr("POL_ELAT") == 90.0
        assert f.get_attr("START_DATE") == "2024-03-25_09:00:00"
        assert f.get_attr("PREC_ACC_DT") == 15
        # CEN_LAT overwritten with domain-center latitude (model_grid.F90:1107)
        assert abs(f.get_attr("CEN_LAT") - 38.5) < 1.0


def test_output_coords_match_grid(full_run):
    _, cfg, art, _, _ = full_run
    with open_dataset(cfg.output_file) as f:
        np.testing.assert_allclose(f.read_var("XLAT")[0], art.grid.lat,
                                   rtol=1e-6)
        np.testing.assert_allclose(f.read_var("XLONG_U")[0], art.grid.lon_u,
                                   rtol=1e-6)
        np.testing.assert_allclose(f.read_var("MAPFAC_V")[0], art.grid.mapfac_v,
                                   rtol=1e-6)
        np.testing.assert_allclose(f.read_var("SINALPHA")[0], art.grid.sina,
                                   atol=1e-6)


def test_times_and_xtime(full_run):
    _, cfg, art, _, _ = full_run
    with open_dataset(cfg.output_file) as f:
        times = f.read_var("Times")
        s = b"".join(times[0].reshape(-1)).decode()
        assert s == "2024-03-25_10:00:00"
        # quirk Q11: XTIME = start - valid -> NEGATIVE 60 minutes
        assert f.read_var("XTIME")[0] == -60.0
        assert f.read_var("ITIMESTEP")[0] == int(-3600 / 60.0)


def test_field_values_smooth(full_run):
    mesh, cfg, art, hist_fields, diag_fields = full_run
    g = art.grid
    ref2 = smooth(g.lat, g.lon)
    # bilinear interpolation of a smooth field carries O(h^2) error; the
    # measured constant is ~0.4*amp*h^2, so amp*h^2 is a tight 2.5x margin
    h2 = mesh.mean_cell_spacing_rad() ** 2
    with open_dataset(cfg.output_file) as f:
        t2 = f.read_var("T2")[0]
        np.testing.assert_allclose(t2, 280.0 + 5 * ref2, atol=5 * h2)
        tsk = f.read_var("TSK")[0]
        np.testing.assert_allclose(tsk, 285.0 + 5 * ref2, atol=5 * h2)
        # nearest: categorical values preserved exactly
        xland = f.read_var("XLAND")[0]
        assert set(np.unique(xland)) <= {1.0, 2.0}
        # conservative snow stays within range and close to smooth field
        snowmax = hist_fields["snow"].max()
        snow = f.read_var("SNOW")[0]
        assert snow.min() >= -1e-6 and snow.max() <= snowmax + 1e-6
        # 3-D diag var on nz levels
        refl = f.read_var("REFL_10CM")[0]
        assert refl.shape == (mesh.nz, g.ny, g.nx)
        np.testing.assert_allclose(refl[0], 20.0 + ref2, atol=h2)
        # vertex-located field
        vort = f.read_var("VORT")[0]
        np.testing.assert_allclose(vort[0], 1e-4 * ref2, atol=1e-4 * h2)
        # soil: quirk Q3 — soil regridded NEAREST (values are exact samples)
        tslb = f.read_var("TSLB")[0]
        vals = np.unique(np.round(tslb[0].reshape(-1), 10))
        src_vals = np.unique(np.round(hist_fields["tslb"][:, 0], 10))
        assert np.isin(vals, np.round(src_vals.astype(np.float32), 10)).all()


def test_wrf_mod_transforms(full_run):
    mesh, cfg, art, hist_fields, _ = full_run
    g = art.grid
    with open_dataset(cfg.output_file) as f:
        # T = theta - 300 (quirk Q7)
        ref2 = smooth(g.lat, g.lon)
        h2 = mesh.mean_cell_spacing_rad() ** 2
        t = f.read_var("T")[0]
        np.testing.assert_allclose(t[0], 10.0 * ref2, atol=10 * h2)
        # MU, PH, P all zero
        assert (f.read_var("MU") == 0).all()
        assert (f.read_var("PH") == 0).all()
        assert (f.read_var("P") == 0).all()
        # PB == P_HYD values
        np.testing.assert_allclose(f.read_var("PB"), f.read_var("P_HYD"))
        # PHB = zgrid * 9.81: check bottom level consistency
        phb = f.read_var("PHB")[0]
        zc = f.read_var("Z_C")[0]
        np.testing.assert_allclose(
            zc[0], 0.5 * (phb[0] + phb[1]) / 9.81, rtol=1e-5)
        # Z_C top interface left at netCDF fill value
        assert (zc[mesh.nz] > 9e36).all()
        # P_TOP rule
        p_hyd = f.read_var("P_HYD")[0]
        top = p_hyd[mesh.nz - 1]
        expect = min(float(p_hyd.max()), float((top[top >= 10.0] * 0.8).min()))
        np.testing.assert_allclose(f.read_var("P_TOP")[0], expect, rtol=1e-6)


def test_staggered_winds(full_run):
    mesh, cfg, art, _, _ = full_run
    g = art.grid
    with open_dataset(cfg.output_file) as f:
        u = f.read_var("U")[0]
        v = f.read_var("V")[0]
        assert u.shape == (mesh.nz, g.ny, g.nx + 1)
        assert v.shape == (mesh.nz, g.ny + 1, g.nx)
        # quirk Q6: outermost staggered columns/rows are unmapped -> 0
        assert (u[:, :, 0] == 0).all() and (u[:, :, -1] == 0).all()
        assert (v[:, 0, :] == 0).all() and (v[:, -1, :] == 0).all()
        # interior U approximates rotated zonal wind ~ 15 + f
        assert abs(u[0, :, 1:-1].mean() - 15.0) < 1.5
        assert abs(v[0, 1:-1, :].mean() - (-5.0)) < 1.5


def test_u10_rotation_applied(full_run):
    """Diag u10/v10 get the 2-D rotation on Lambert grids."""
    mesh, cfg, art, _, diag_fields = full_run
    g = art.grid
    with open_dataset(cfg.output_file) as f:
        u10 = f.read_var("U10")[0]
    # compare against manual: bilinear interp then rotate (art.data fields
    # are in the pipeline's cell_order numbering, matching the regridders)
    from mpassit_jax.ops.rotate import rotate_winds
    rg = art.regridders["bilinear"]
    ui = rg.apply_np(art.data.fields["u10"])
    vi = rg.apply_np(art.data.fields["v10"])
    ur, vr = rotate_winds(jnp.asarray(ui), jnp.asarray(vi),
                          jnp.asarray(g.cosa), jnp.asarray(g.sina))
    np.testing.assert_allclose(u10, np.asarray(ur, dtype=np.float32), rtol=1e-6)


def test_diag_only_run(tmp_path):
    mesh, cfg, _, diag_fields = make_case(tmp_path, wrf_mod_vars=False,
                                          interp_hist=False)
    art = run_pipeline(cfg, dtype=jnp.float64)
    with open_dataset(cfg.output_file) as f:
        assert f.has_var("T2")
        assert not f.has_var("T")
        assert not f.has_var("P")  # no wrf_mod dummies
        assert f.get_attr("SF_SURFACE_PHYSICS") == 0  # no hist file read


def test_neither_flag_errors(tmp_path):
    mesh, cfg, _, _ = make_case(tmp_path, interp_diag=False, interp_hist=False)
    cfg.interp_diag = cfg.interp_hist = False
    with pytest.raises(ValueError, match="INTERP_DIAG"):
        run_pipeline(cfg)


def test_cell_order_none_matches_morton(tmp_path, full_run):
    """cell_order='none' (file order) produces the same fields as the
    default Morton renumbering — the reorder is locality-only."""
    _, _, morton_art, _, _ = full_run
    mesh, cfg, _, _ = make_case(tmp_path)
    cfg.cell_order = "none"
    art = run_pipeline(cfg, dtype=jnp.float64)
    for (na, a, *_), (nb, b, *_) in zip(
            art.result.diag2d + art.result.nz3d + art.result.cons2d,
            morton_art.result.diag2d + morton_art.result.nz3d
            + morton_art.result.cons2d):
        assert na == nb
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=na)
    np.testing.assert_allclose(art.result.u, morton_art.result.u, atol=1e-12)


def test_interp_as_bundle_false_matches_bundle(tmp_path, full_run):
    """interp_as_bundle=.false. regrids conservative fields one at a time
    (interp.F90:368-416); the results must match the bundled apply."""
    _, bundle_cfg, bundle_art, _, _ = full_run
    mesh, cfg, _, _ = make_case(tmp_path)
    cfg.interp_as_bundle = False
    art = run_pipeline(cfg, dtype=jnp.float64)
    assert [n for n, *_ in art.result.cons2d] == \
        [n for n, *_ in bundle_art.result.cons2d]
    for (na, a, *_), (nb, b, *_) in zip(art.result.cons2d,
                                        bundle_art.result.cons2d):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_packed_apply_matches_unpacked(tmp_path, monkeypatch):
    """The cross-method packed apply (one union-slab kernel pass for
    bilinear+nearest+conserve) must reproduce the per-method batch results
    — the zero-weight union rows contribute exact 0.0 terms. The packed run
    also rotates the mass winds IN-APPLY (quirk Q4, Lambert) while the
    no-pack run takes the post-hoc rotate_winds path, so u/v equality pins
    the two rotation routes against each other end-to-end."""
    mesh, cfg, _, _ = make_case(tmp_path)
    art_packed = run_pipeline(cfg, dtype=jnp.float32)
    monkeypatch.setenv("MPASSIT_NO_PACK", "1")
    cfg.output_file = str(tmp_path / "out_nopack.nc")
    art_plain = run_pipeline(cfg, dtype=jnp.float32)
    for cat in ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d",
                "cons2d", "nstd2d", "soil"):
        for (na, a, *_), (nb, b, *_) in zip(
                getattr(art_packed.result, cat) or [],
                getattr(art_plain.result, cat) or []):
            assert na == nb
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                       err_msg=na)
    np.testing.assert_allclose(art_packed.result.u, art_plain.result.u,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(art_packed.result.v, art_plain.result.v,
                               rtol=1e-6, atol=1e-6)
