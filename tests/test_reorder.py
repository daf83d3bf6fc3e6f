"""Mesh reordering (mesh/reorder.py): geometry preservation + equivalence.

Restored from the removed test_pallas_apply.py (ADVICE r2): reorder.py is
live code — run_pipeline renumbers source cells along a target-space
Z-curve by default (cell_order='morton') for slab-gather locality, the
role the reference's METIS decomposition file plays
(model_grid.F90:2367-2426)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpassit_jax.mesh.reorder import (
    apply_perm,
    latitude_band_order,
    reorder_cells_by_latitude,
    reorder_cells_morton,
)
from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_jax.ops.apply import Regridder
from mpassit_jax.weights.bilinear import bilinear_cell_weights

from test_weights import coarse_lambert_grid


@pytest.fixture(scope="module")
def problem():
    mesh = synthetic_voronoi_mesh(ncells=3000, nz=3, nsoil=1, seed=9)
    grid = coarse_lambert_grid(nx=64, ny=40, dx=80e3)
    ro = reorder_cells_morton(mesh, grid.proj)
    ell = bilinear_cell_weights(ro.mesh, grid.lat, grid.lon)
    return mesh, ro, grid, ell


def test_reorder_preserves_geometry(problem):
    mesh, ro, grid, ell = problem
    m2 = ro.mesh
    assert np.allclose(np.sort(m2.lat_cell), np.sort(mesh.lat_cell))
    # connectivity still inverts
    for v in (0, 100, m2.nvertices - 1):
        for c in m2.cells_on_vertex[v]:
            assert v in m2.vertices_on_cell[c]
    # band ordering: lat nondecreasing across band starts
    order = latitude_band_order(mesh.lat_cell, mesh.lon_cell, 5.0)
    assert (np.diff(np.floor((mesh.lat_cell[order] + 90) / 5.0)) >= 0).all()


def test_reorder_equivalent_result(problem):
    """Regrid through the reordered mesh == regrid through the original."""
    mesh, ro, grid, ell = problem
    ell0 = bilinear_cell_weights(mesh, grid.lat, grid.lon)
    f = np.sin(np.deg2rad(mesh.lat_cell)) * np.cos(np.deg2rad(mesh.lon_cell))
    out0 = Regridder(ell0, dtype=jnp.float64).apply_np(f)
    out1 = Regridder(ell, dtype=jnp.float64).apply_np(apply_perm(f, ro.perm))
    np.testing.assert_allclose(out1, out0, atol=1e-12)


def test_latitude_fallback_equivalent(problem):
    """reorder_cells_by_latitude (the no-projection fallback run_pipeline
    uses for lat-lon targets) also preserves results."""
    mesh, ro, grid, ell = problem
    ro2 = reorder_cells_by_latitude(mesh)
    ell0 = bilinear_cell_weights(mesh, grid.lat, grid.lon)
    ell2 = bilinear_cell_weights(ro2.mesh, grid.lat, grid.lon)
    f = np.cos(np.deg2rad(mesh.lat_cell)) * mesh.lon_cell
    out0 = Regridder(ell0, dtype=jnp.float64).apply_np(f)
    out2 = Regridder(ell2, dtype=jnp.float64).apply_np(
        apply_perm(f, ro2.perm))
    np.testing.assert_allclose(out2, out0, atol=1e-12)
