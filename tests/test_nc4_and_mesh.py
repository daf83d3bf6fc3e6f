import numpy as np

from mpassit_jax.io.nc4 import NetCDF4File, open_dataset
from mpassit_jax.mesh.mpas import mesh_from_file
from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh, write_mpas_grid_file


def test_nc4_roundtrip(tmp_path):
    p = str(tmp_path / "t.nc")
    with NetCDF4File(p, "w") as f:
        f.create_dim("x", 4)
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)
        f.create_var("a", ("Time", "x"), "f4", np.arange(4, dtype=np.float32)[None])
        f.set_attr("title", "hello")
        f.set_attr("count", 3)
        f.set_attr("dx", 3000.0)
        f.set_attr("units", "m", var="a")
    with open_dataset(p) as f:
        assert f.dim_size("x") == 4
        assert f.get_attr("title") == "hello"
        assert f.get_attr("count") == 3
        assert f.get_attr("dx") == 3000.0
        assert f.var_attrs("a")["units"] == "m"
        assert np.allclose(f.read_var("a"), [[0, 1, 2, 3]])
        assert f.var_dims("a") == ["Time", "x"]
        assert "a" in f.var_names()


def test_classic_reader(tmp_path):
    from scipy.io import netcdf_file

    p = str(tmp_path / "classic.nc")
    f = netcdf_file(p, "w")
    f.createDimension("n", 3)
    v = f.createVariable("v", "d", ("n",))
    v[:] = [1.0, 2.0, 3.0]
    v.units = b"K"
    f.history = b"classic"
    f.close()

    with open_dataset(p) as f:
        assert f.dim_size("n") == 3
        assert np.allclose(f.read_var("v"), [1, 2, 3])
        assert f.var_attrs("v")["units"] == "K"
        assert f.get_attr("history") == "classic"


def test_synthetic_mesh_topology():
    mesh = synthetic_voronoi_mesh(ncells=300, nz=3, nsoil=2)
    assert mesh.ncells == 300
    # Euler characteristic of a spherical Voronoi diagram with triple points:
    # V - E + F = 2 and 3V = 2E  =>  V = 2F - 4
    assert mesh.nvertices == 2 * mesh.ncells - 4
    # every vertex has exactly 3 cells (global mesh)
    assert (mesh.cells_on_vertex >= 0).all()
    # cells_on_vertex inverts verticesOnCell
    for v in [0, 17, mesh.nvertices - 1]:
        for c in mesh.cells_on_vertex[v]:
            assert v in mesh.vertices_on_cell[c]
    # unit vectors
    assert np.allclose(np.linalg.norm(mesh.xyz_cell, axis=1), 1.0)


def test_mesh_file_roundtrip(tmp_path):
    mesh = synthetic_voronoi_mesh(ncells=200, nz=5, nsoil=3)
    p = str(tmp_path / "grid.nc")
    write_mpas_grid_file(mesh, p)
    m2 = mesh_from_file(p)
    assert m2.ncells == mesh.ncells
    assert m2.nvertices == mesh.nvertices
    assert m2.nz == 5 and m2.nzp1 == 6 and m2.nsoil == 3
    assert np.allclose(m2.lat_cell, mesh.lat_cell)
    # quirk Q8: longitudes wrapped to (-180, 180]
    assert (m2.lon_cell <= 180.0).all() and (m2.lon_cell > -180.0).all()
    assert np.allclose(np.mod(m2.lon_cell, 360), np.mod(mesh.lon_cell, 360))
    assert np.array_equal(m2.vertices_on_cell, mesh.vertices_on_cell)
    assert np.array_equal(m2.cells_on_vertex, mesh.cells_on_vertex)
    assert np.allclose(m2.ter, mesh.ter)
    assert np.allclose(m2.zs, mesh.zs)
    # fingerprint is deterministic for a given file (cache key property);
    # not bit-identical to the in-memory mesh (degrees<->radians round trip)
    assert m2.fingerprint() == mesh_from_file(p).fingerprint()
