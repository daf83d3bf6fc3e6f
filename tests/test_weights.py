import numpy as np
import pytest

from mpassit_jax.config import Config
from mpassit_jax.grids.target import build_target_grid
from mpassit_jax.mesh.mpas import lonlat_to_xyz
from mpassit_jax.weights.bilinear import (
    bilinear_cell_weights,
    bilinear_vertex_weights,
)
from mpassit_jax.weights.conservative import conservative_weights
from mpassit_jax.weights.ell import ELLWeights
from mpassit_jax.weights.nearest import nearest_weights


def coarse_lambert_grid(nx=30, ny=24, dx=150e3):
    cfg = Config.from_dict({
        "target_grid_type": "lambert", "nx": nx + 1, "ny": ny + 1,
        "dx": dx, "dy": dx, "ref_lat": 38.5, "ref_lon": -97.5,
        "truelat1": 38.5, "stand_lon": -97.5,
    })
    return build_target_grid(cfg)


@pytest.fixture(scope="module")
def grid():
    return coarse_lambert_grid()


def test_nearest_matches_bruteforce(small_mesh, grid):
    ell = nearest_weights(small_mesh, grid.lat, grid.lon)
    ell.validate()
    assert ell.k == 1
    assert ell.mapped.all()
    p = lonlat_to_xyz(grid.lon.reshape(-1), grid.lat.reshape(-1))
    # brute force on a subsample
    sub = np.arange(0, p.shape[0], 37)
    d2 = ((p[sub, None, :] - small_mesh.xyz_cell[None, :, :]) ** 2).sum(-1)
    assert np.array_equal(ell.idx[sub, 0], d2.argmin(axis=1))


def test_bilinear_global_mesh_all_mapped(small_mesh, grid):
    ell = bilinear_cell_weights(small_mesh, grid.lat, grid.lon)
    ell.validate()
    assert ell.k == 3
    assert ell.mapped.all()  # global mesh covers any target
    # weights in [0,1], sum 1
    assert (ell.w >= 0).all() and (ell.w <= 1 + 1e-12).all()


def test_bilinear_constant_and_smooth(small_mesh, grid):
    ell = bilinear_cell_weights(small_mesh, grid.lat, grid.lon)
    const = np.full(small_mesh.ncells, 7.25)
    out = (ell.w * const[ell.idx]).sum(axis=1)
    np.testing.assert_allclose(out, 7.25, rtol=1e-13)

    # smooth field: f = sin(lat)*cos(lon); interp error ~ O(h^2), h ~ 9deg
    f = np.sin(np.deg2rad(small_mesh.lat_cell)) * np.cos(
        np.deg2rad(small_mesh.lon_cell))
    out = (ell.w * f[ell.idx]).sum(axis=1).reshape(grid.shape)
    ref = np.sin(np.deg2rad(grid.lat)) * np.cos(np.deg2rad(grid.lon))
    assert np.abs(out - ref).max() < 0.01


def test_bilinear_triangle_contains_nearest_region(small_mesh, grid):
    """The interpolating triangle's cells should be local to the point."""
    ell = bilinear_cell_weights(small_mesh, grid.lat, grid.lon)
    p = lonlat_to_xyz(grid.lon.reshape(-1), grid.lat.reshape(-1))
    tri_xyz = small_mesh.xyz_cell[ell.idx]        # (T, 3, 3)
    d = np.linalg.norm(tri_xyz - p[:, None, :], axis=2)
    h = small_mesh.mean_cell_spacing_rad()
    assert d.max() < 2.5 * h


def test_bilinear_vertex_constant(small_mesh, grid):
    ell = bilinear_vertex_weights(small_mesh, grid.lat, grid.lon)
    ell.validate()
    assert ell.src_loc == "node"
    assert ell.mapped.all()
    const = np.full(small_mesh.nvertices, -3.5)
    out = (ell.w * const[ell.idx]).sum(axis=1)
    np.testing.assert_allclose(out, -3.5, rtol=1e-13)
    # smooth field through vertices
    f = np.sin(np.deg2rad(small_mesh.lat_vertex))
    out = (ell.w * f[ell.idx]).sum(axis=1).reshape(grid.shape)
    ref = np.sin(np.deg2rad(grid.lat))
    assert np.abs(out - ref).max() < 0.01


def test_conservative_partition_of_unity(small_mesh, grid):
    """Global source mesh tiles the sphere -> overlap fractions per target
    sum to 1 (up to gnomonic/greatcircle edge mismatch ~ (h_src*h_tgt)^2)."""
    ell = conservative_weights(small_mesh, grid)
    ell.validate()
    sums = ell.row_sums().reshape(grid.shape)
    np.testing.assert_allclose(sums, 1.0, atol=5e-3)
    # constant preserved to the same tolerance
    const = np.full(small_mesh.ncells, 2.0)
    out = (ell.w * const[ell.idx]).sum(axis=1)
    np.testing.assert_allclose(out, 2.0, atol=1e-2)


def test_conservative_weights_positive_and_local(small_mesh, grid):
    ell = conservative_weights(small_mesh, grid)
    assert (ell.w >= 0).all()
    # every contributing source cell is near its target
    t_ids, k_ids = np.nonzero(ell.w > 1e-6)
    p = lonlat_to_xyz(grid.lon.reshape(-1), grid.lat.reshape(-1))
    src = small_mesh.xyz_cell[ell.idx[t_ids, k_ids]]
    d = np.linalg.norm(src - p[t_ids], axis=1)
    assert d.max() < 2.0 * small_mesh.mean_cell_spacing_rad()


def test_conservative_linear_field_accuracy(small_mesh, grid):
    """Cell-average of a linear-in-xyz field is approximately the field at
    the centroid; conservative remap of such a field should track it."""
    ell = conservative_weights(small_mesh, grid)
    f = small_mesh.xyz_cell @ np.array([0.3, -0.5, 0.8])
    out = (ell.w * f[ell.idx]).sum(axis=1).reshape(grid.shape)
    ref = lonlat_to_xyz(grid.lon, grid.lat) @ np.array([0.3, -0.5, 0.8])
    # first-order method on a ~9deg mesh (cell-point value stands in for the
    # cell average): error ~ h^2/2 ~ 0.06 worst-case
    assert np.abs(out - ref).max() < 0.08
    assert np.abs(out - ref).mean() < 0.02


def test_ell_save_load(tmp_path, small_mesh, grid):
    ell = nearest_weights(small_mesh, grid.lat, grid.lon)
    p = str(tmp_path / "w.npz")
    ell.save(p)
    ell2 = ELLWeights.load(p)
    assert np.array_equal(ell.idx, ell2.idx)
    assert np.array_equal(ell.w, ell2.w)
    assert ell2.method == "nearest"
    assert ell2.dst_shape == ell.dst_shape


def test_regional_mesh_unmapped_rows(grid):
    """Targets outside a regional mesh hull are unmapped (quirk Q5)."""
    from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh

    mesh = synthetic_voronoi_mesh(ncells=500, nz=3, nsoil=1)
    # fake a regional mesh by keeping only cells near the grid center:
    # targets far from kept cells must produce zero rows rather than garbage
    far_lat = np.array([[ -70.0 ]])
    far_lon = np.array([[ 10.0 ]])
    ell = bilinear_cell_weights(mesh, far_lat, far_lon)
    assert ell.mapped.all()  # global mesh: still mapped
    # build a true boundary case: vertex with incomplete cellsOnVertex
    mesh.cells_on_vertex = mesh.cells_on_vertex.copy()
    mesh.cells_on_vertex[:, :] = -1  # destroy all triangles
    ell = bilinear_cell_weights(mesh, far_lat, far_lon)
    assert not ell.mapped.any()
    assert (ell.w == 0).all()
