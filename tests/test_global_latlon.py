"""Global lat-lon (quirk Q9) pipeline coverage — VERDICT r3 item 5.

The reference builds a periodic global grid with monopole rows
(program_setup.F90:195-211, model_grid.F90:684-696): dlon = 360/i_target,
cell centers starting at -90 + dlat/2, corner rows touching the poles.
The periodic seam column and the pole-adjacent target cells are exactly
where the corner-quad geometry could misbehave, so this runs the FULL
pipeline (bilinear + conservative + nearest + soil + winds) onto the
global grid and asserts seam continuity, pole-row sanity, and
conservative full-coverage row sums.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mpassit_jax.grids.target import build_target_grid
from mpassit_jax.io.nc4 import open_dataset
from mpassit_jax.run.pipeline import run_pipeline

from test_pipeline import make_case, smooth

NX, NY = 36, 19


@pytest.fixture(scope="module")
def global_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("global")
    mesh, cfg, hist_fields, diag_fields = make_case(
        d, ncells=3000,
        cfg_overrides={
            "target_grid_type": "lat-lon", "is_regional": False,
            "nx": NX + 1, "ny": NY + 1,
            "dx": None, "dy": None,             # global mode: dx/dy unset
            "ref_lat": None, "ref_lon": None,
            "truelat1": None, "stand_lon": 0.0,
        })
    art = run_pipeline(cfg, dtype=jnp.float64)
    return mesh, cfg, art, hist_fields, diag_fields


def test_global_grid_structure(global_run):
    """Q9 derivations: dlon=360/nx, centers from -90+dlat/2, periodic."""
    _, cfg, art, _, _ = global_run
    g = art.grid
    assert g.lat.shape == (NY, NX)
    np.testing.assert_allclose(g.lat[0, 0], -90.0 + (180.0 / NY) / 2.0)
    np.testing.assert_allclose(g.lat[-1, 0], 90.0 - (180.0 / NY) / 2.0)
    np.testing.assert_allclose(np.diff(g.lon[0]) % 360.0, 360.0 / NX)
    # corner rows touch the monopoles (model_grid.F90:684-696)
    np.testing.assert_allclose(g.lat_corner[0, :], -90.0)
    np.testing.assert_allclose(g.lat_corner[-1, :], 90.0)


def test_global_all_mapped_and_finite(global_run):
    """A global mesh covers every target point: no unmapped zeros anywhere,
    including the pole rows and the seam column."""
    _, _, art, _, _ = global_run
    for cat in ("diag2d", "patch2d", "nstd2d", "cons2d", "nz3d", "soil"):
        for name, arr, *_ in getattr(art.result, cat):
            assert np.isfinite(arr).all(), (cat, name)
    t2 = dict((n, a) for n, a, *_ in art.result.diag2d)["T2"]
    assert t2.min() > 270.0 and t2.max() < 290.0  # 280 +- 5*smooth


def test_global_seam_continuity(global_run):
    """Columns 0 and NX-1 are physically adjacent across the 360-degree
    seam: for the smooth synthetic field their values must differ by no
    more than neighboring interior columns do."""
    _, _, art, _, _ = global_run
    t2 = dict((n, a) for n, a, *_ in art.result.diag2d)["T2"]
    seam_jump = np.abs(t2[:, 0] - t2[:, -1]).max()
    interior_jump = np.abs(np.diff(t2, axis=1)).max()
    assert seam_jump <= 1.5 * interior_jump + 1e-9, (
        seam_jump, interior_jump)


def test_global_conservative_row_sums(global_run):
    """Conservative weights on a fully-covered global grid must have
    row-sum 1 EVERYWHERE — including the pole-adjacent cells whose corner
    quads degenerate to triangles at the monopole, and the seam column
    whose quads span the +/-180 wrap."""
    _, _, art, _, _ = global_run
    ell = None
    from mpassit_jax.weights.conservative import conservative_weights

    mesh, cfg = art.mesh, art.cfg
    ell = conservative_weights(mesh, art.grid)
    sums = ell.row_sums().reshape(NY, NX)
    np.testing.assert_allclose(sums, 1.0, atol=5e-3)
    # pole rows and seam column specifically
    np.testing.assert_allclose(sums[0, :], 1.0, atol=5e-3)
    np.testing.assert_allclose(sums[-1, :], 1.0, atol=5e-3)
    np.testing.assert_allclose(sums[:, 0], 1.0, atol=5e-3)


def test_global_bilinear_accuracy(global_run):
    """Bilinear output of the smooth field matches the analytic value to
    mesh-resolution error everywhere, pole rows included."""
    _, _, art, _, _ = global_run
    g = art.grid
    t2 = dict((n, a) for n, a, *_ in art.result.diag2d)["T2"]
    truth = 280.0 + 5.0 * smooth(g.lat, g.lon)
    err = np.abs(t2 - truth)
    # worst-case dual triangles of a random 3000-cell Voronoi mesh span
    # several degrees; interp error is O(amplitude * h^2) in the mean with
    # a fat tail at the sparsest triangles
    assert err.mean() < 0.1 and err.max() < 1.0, (err.mean(), err.max())


def test_global_output_file(global_run):
    """The written file carries the global grid and finite fields."""
    _, cfg, _, _, _ = global_run
    with open_dataset(cfg.output_file) as f:
        xlat = np.asarray(f.read_var("XLAT"))
        assert xlat.shape[-2:] == (NY, NX)
        snow = np.asarray(f.read_var("SNOW"))
        assert np.isfinite(snow).all()
        u = np.asarray(f.read_var("U"))
        assert u.shape[-1] == NX + 1
        assert np.isfinite(u).all()
