"""netCDF-C interoperability proof.

Downstream consumers (UPP, ncdump) read the output through netCDF-C. Our
writer hand-rolls the classic CDF-2 format (io/nc4.ClassicFile), so these
tests open every produced file with the REAL system libnetcdf (ctypes
binding, mpassit_jax/io/netcdf_c.py) and assert nc_open-level readability
of dims, vars, attrs, and values against the repo's own reader.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mpassit_jax.io import netcdf_c
from mpassit_jax.io.nc4 import open_dataset
from mpassit_jax.run.pipeline import run_pipeline

from test_pipeline import make_case

pytestmark = pytest.mark.skipif(
    not netcdf_c.available(), reason="system libnetcdf not present")


@pytest.fixture(scope="module")
def out_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("ncinterop")
    mesh, cfg, hist_fields, diag_fields = make_case(d)
    run_pipeline(cfg, dtype=jnp.float64)
    return cfg.output_file


def test_nc_open_and_inventory(out_file):
    with netcdf_c.NetCDFCFile(out_file) as nc, open_dataset(out_file) as h5:
        # every dim the writer defined (write_data.F90:177-194 schema)
        for dim in ("Time", "west_east", "west_east_stag", "south_north",
                    "south_north_stag", "bottom_top", "bottom_top_stag",
                    "soil_layers_stag", "StrLen"):
            assert nc.has_dim(dim), dim
            assert nc.dim_size(dim) == h5.dim_size(dim), dim
        # Time must be the unlimited dimension, as in the reference
        assert nc.unlimited_dim() == "Time"
        # definition order survives (netCDF-C enumerates by creation order)
        assert nc.dim_names()[0] == "Time"
        # full variable inventory agrees with the repo reader's view
        assert set(nc.var_names()) == set(h5.var_names())


def test_nc_var_dims_and_values(out_file):
    with netcdf_c.NetCDFCFile(out_file) as nc, open_dataset(out_file) as h5:
        for name in nc.var_names():
            assert nc.var_dims(name) == h5.var_dims(name), name
            got = nc.read_var(name)
            want = h5.read_var(name)
            assert got.shape == want.shape, name
            if got.dtype.kind == "S":
                assert (got == want).all(), name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_nc_global_attrs(out_file):
    with netcdf_c.NetCDFCFile(out_file) as nc, open_dataset(out_file) as h5:
        names = nc.global_attr_names()
        for key in ("WEST-EAST_GRID_DIMENSION", "DX", "MAP_PROJ",
                    "MAP_PROJ_CHAR", "TRUELAT1", "CEN_LAT", "START_DATE",
                    "POL_ELAT"):
            assert key in names, key
            assert nc.get_attr(key) == h5.get_attr(key), key
        # the file is CDF-2, the 64-bit-offset classic format WRF writes
        assert nc.format() == netcdf_c.NC_FORMAT_64BIT_OFFSET


def test_nc_var_attrs_and_types(out_file):
    with netcdf_c.NetCDFCFile(out_file) as nc:
        t2 = nc.var_attrs("T2")
        assert t2["MemoryOrder"] == "XY "
        assert t2["stagger"] == ""
        assert nc.var_attrs("U")["stagger"] == "X"
        assert nc.var_attrs("V")["stagger"] == "Y"
        assert nc.var_dtype("T2") == np.float32
        assert nc.var_dtype("ITIMESTEP") == np.int32
        assert nc.var_dtype("Times") == np.dtype("S1")


def test_nc_times_string(out_file):
    with netcdf_c.NetCDFCFile(out_file) as nc:
        times = nc.read_var("Times")
        assert times.shape[1] == 19  # quirk Q11: DateStrLen=19
        s = b"".join(times[0].reshape(-1)).decode()
        assert s == "2024-03-25_10:00:00"


def test_nc_reads_our_mpas_style_inputs(tmp_path):
    """The synthetic MPAS grid/data files we write are also real netCDF."""
    from mpassit_jax.mesh.synthetic import (
        synthetic_voronoi_mesh, write_mpas_grid_file)

    mesh = synthetic_voronoi_mesh(ncells=300, nz=3, nsoil=2, seed=11)
    path = str(tmp_path / "grid.nc")
    write_mpas_grid_file(mesh, path)
    with netcdf_c.NetCDFCFile(path) as nc:
        assert nc.dim_size("nCells") == mesh.ncells
        voc = nc.read_var("verticesOnCell")
        assert voc.shape == (mesh.ncells, mesh.max_edges)
        lat = nc.read_var("latCell")
        np.testing.assert_allclose(np.rad2deg(lat), mesh.lat_cell, atol=1e-10)
