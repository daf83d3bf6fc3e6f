"""Pure-Python CDF-5 reading (io/nc4.ClassicFile) against real libnetcdf.

Production MPAS runs write CDF-5 ("64-bit data" classic, magic CDF\\x05)
once any variable exceeds CDF-2's 4 GiB limit; scipy.io.netcdf_file only
parses CDF-1/2. Files here are WRITTEN by the system libnetcdf through
ctypes (zero shared code with the parser) and cross-checked against
io/netcdf_c.NetCDFCFile — the same library the reference links
(CMakeLists.txt:46)."""

import ctypes

import numpy as np
import pytest

from mpassit_jax.io import netcdf_c
from mpassit_jax.io.nc4 import ClassicFile, open_dataset

pytestmark = pytest.mark.skipif(
    not netcdf_c.available(), reason="system libnetcdf not found")

NC_CLOBBER, NC_64BIT_DATA, NC_UNLIMITED = 0, 0x0020, 0
NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_INT64 = 10
NC_GLOBAL = -1


def _lib():
    lib = netcdf_c.load_libnetcdf()
    lib.nc_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
    return lib


def _check(rc, what):
    assert rc == 0, f"{what} rc={rc}"


def _write_mpas_like_cdf5(path, ncells=7, nz=3, nrec=2):
    """Dims/vars shaped like an MPAS history stream: Time unlimited,
    xtime char, double coords, float 3-D field, int category field."""
    lib = _lib()
    ncid = ctypes.c_int()
    _check(lib.nc_create(str(path).encode(), NC_CLOBBER | NC_64BIT_DATA,
                         ctypes.byref(ncid)), "create")
    d_time, d_cells, d_nz, d_str = (ctypes.c_int() for _ in range(4))
    _check(lib.nc_def_dim(ncid, b"Time", NC_UNLIMITED,
                          ctypes.byref(d_time)), "dim Time")
    _check(lib.nc_def_dim(ncid, b"nCells", ncells,
                          ctypes.byref(d_cells)), "dim nCells")
    _check(lib.nc_def_dim(ncid, b"nVertLevels", nz, ctypes.byref(d_nz)),
           "dim nz")
    _check(lib.nc_def_dim(ncid, b"StrLen", 19, ctypes.byref(d_str)),
           "dim StrLen")

    def def_var(name, nct, dims):
        vid = ctypes.c_int()
        arr = (ctypes.c_int * len(dims))(*[d.value for d in dims])
        _check(lib.nc_def_var(ncid, name, nct, len(dims), arr,
                              ctypes.byref(vid)), f"def {name}")
        return vid

    v_lon = def_var(b"lonCell", NC_DOUBLE, [d_cells])
    v_t = def_var(b"theta", NC_FLOAT, [d_time, d_cells, d_nz])
    v_cat = def_var(b"ivgtyp", NC_INT, [d_time, d_cells])
    v_xt = def_var(b"xtime", NC_CHAR, [d_time, d_str])

    _check(lib.nc_put_att_text(ncid, v_t, b"units", 5, b"K    "), "att")
    _check(lib.nc_put_att_text(ncid, NC_GLOBAL, b"config_start_time", 19,
                               b"2024-03-25_10:00:00"), "gatt")
    dt_att = (ctypes.c_double * 1)(60.0)
    _check(lib.nc_put_att_double(ncid, NC_GLOBAL, b"config_dt", NC_DOUBLE,
                                 1, dt_att), "gatt dt")
    _check(lib.nc_enddef(ncid), "enddef")

    rng = np.random.default_rng(5)
    lon = rng.uniform(0, 2 * np.pi, ncells)
    theta = rng.standard_normal((nrec, ncells, nz)).astype(np.float32)
    cat = rng.integers(1, 20, (nrec, ncells)).astype(np.int32)
    xt = np.array([b"2024-03-25_10:00:00", b"2024-03-25_11:00:00"])[:nrec]

    _check(lib.nc_put_var_double(
        ncid, v_lon, lon.ctypes.data_as(ctypes.POINTER(ctypes.c_double))),
        "put lon")
    start = (ctypes.c_size_t * 3)(0, 0, 0)
    cnt = (ctypes.c_size_t * 3)(nrec, ncells, nz)
    _check(lib.nc_put_vara_float(
        ncid, v_t, start, cnt,
        theta.ctypes.data_as(ctypes.POINTER(ctypes.c_float))), "put theta")
    cnt2 = (ctypes.c_size_t * 2)(nrec, ncells)
    _check(lib.nc_put_vara_int(
        ncid, v_cat, start, cnt2,
        cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int))), "put cat")
    buf = b"".join(x.ljust(19) for x in xt)
    cnt3 = (ctypes.c_size_t * 2)(nrec, 19)
    _check(lib.nc_put_vara_text(ncid, v_xt, start, cnt3, buf), "put xtime")
    _check(lib.nc_close(ncid), "close")
    return dict(lon=lon, theta=theta, cat=cat, xt=xt, ncells=ncells,
                nz=nz, nrec=nrec)


def test_cdf5_magic_and_dispatch(tmp_path):
    p = tmp_path / "h.nc"
    _write_mpas_like_cdf5(p)
    with open(p, "rb") as f:
        assert f.read(4) == b"CDF\x05"
    ds = open_dataset(str(p))
    assert isinstance(ds, ClassicFile) and ds.version == 5
    ds.close()


def test_cdf5_dims_vars_attrs(tmp_path):
    p = tmp_path / "h.nc"
    ref = _write_mpas_like_cdf5(p)
    with open_dataset(str(p)) as ds:
        assert ds.has_dim("nCells") and ds.dim_size("nCells") == ref["ncells"]
        assert ds.dim_size("Time") == ref["nrec"]      # unlimited resolved
        assert set(ds.var_names()) == {"lonCell", "theta", "ivgtyp", "xtime"}
        assert ds.var_dims("theta") == ["Time", "nCells", "nVertLevels"]
        assert ds.var_attrs("theta")["units"].strip() == "K"
        assert str(ds.get_attr("config_start_time")).startswith("2024-03-25")
        assert float(np.asarray(ds.get_attr("config_dt"))) == 60.0
        assert ds.get_attr("nope", None) is None
        with pytest.raises(KeyError):
            ds.get_attr("nope")


def test_cdf5_values_match_written(tmp_path):
    p = tmp_path / "h.nc"
    ref = _write_mpas_like_cdf5(p)
    with open_dataset(str(p)) as ds:
        np.testing.assert_array_equal(ds.read_var("lonCell"), ref["lon"])
        np.testing.assert_array_equal(ds.read_var("theta"), ref["theta"])
        np.testing.assert_array_equal(ds.read_var("ivgtyp"), ref["cat"])
        xt = np.asarray(ds.read_var("xtime"))
        assert xt.shape == (ref["nrec"], 19)
        assert xt.tobytes().startswith(b"2024-03-25_10:00:00")


def test_cdf5_matches_libnetcdf_reader(tmp_path):
    """The pure-Python parse agrees with libnetcdf's own read of the same
    file — the cross-implementation oracle."""
    p = tmp_path / "h.nc"
    _write_mpas_like_cdf5(p, ncells=11, nz=4, nrec=2)
    with open_dataset(str(p)) as ours, netcdf_c.NetCDFCFile(str(p)) as ref:
        assert set(ours.var_names()) == set(ref.var_names())
        for name in ours.var_names():
            assert ours.var_dims(name) == ref.var_dims(name), name
            a, b = np.asarray(ours.read_var(name)), ref.read_var(name)
            if a.dtype.kind == "S":
                assert a.tobytes() == np.asarray(b).tobytes()
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


_NCT = {"f8": NC_DOUBLE, "f4": NC_FLOAT, "i4": NC_INT, "i8": NC_INT64,
        "i2": NC_SHORT, "i1": NC_BYTE, "S1": NC_CHAR}
_PUT = {"f8": ("nc_put_vara_double", ctypes.c_double),
        "f4": ("nc_put_vara_float", ctypes.c_float),
        "i4": ("nc_put_vara_int", ctypes.c_int),
        "i8": ("nc_put_vara_longlong", ctypes.c_longlong),
        "i2": ("nc_put_vara_short", ctypes.c_short),
        "i1": ("nc_put_vara_schar", ctypes.c_byte)}


def _to_cdf5(src, dst):
    """Rewrite any readable NetCDF file as CDF-5 through libnetcdf (test
    fixture converter; Time becomes the unlimited dim, MPAS convention)."""
    lib = _lib()
    with open_dataset(str(src)) as ds:
        names = ds.var_names()
        # all declared dims, including ones no variable references (MPAS
        # grid files declare nVertLevels etc. as bare dims)
        dims = {d: ds.dim_size(d) for d in ds.dim_names()}
        for n in names:
            shp = np.asarray(ds.read_var(n)).shape
            for d, s in zip(ds.var_dims(n), shp):
                dims.setdefault(d, s)
        ncid = ctypes.c_int()
        _check(lib.nc_create(str(dst).encode(), NC_CLOBBER | NC_64BIT_DATA,
                             ctypes.byref(ncid)), "create")
        dimids = {}
        for d, s in dims.items():
            did = ctypes.c_int()
            size = NC_UNLIMITED if d == "Time" else s
            _check(lib.nc_def_dim(ncid, d.encode(), size,
                                  ctypes.byref(did)), f"dim {d}")
            dimids[d] = did.value

        def put_atts(varid, atts):
            for k, v in atts.items():
                if isinstance(v, str):
                    _check(lib.nc_put_att_text(
                        ncid, varid, k.encode(), len(v.encode()),
                        v.encode()), f"att {k}")
                elif isinstance(v, (float, np.floating)):
                    arr = (ctypes.c_double * 1)(float(v))
                    _check(lib.nc_put_att_double(
                        ncid, varid, k.encode(), NC_DOUBLE, 1, arr),
                        f"att {k}")
                else:
                    arr = (ctypes.c_int * 1)(int(v))
                    _check(lib.nc_put_att_int(
                        ncid, varid, k.encode(), NC_INT, 1, arr),
                        f"att {k}")

        vids = {}
        for n in names:
            a = np.asarray(ds.read_var(n))
            key = "S1" if a.dtype.kind == "S" else a.dtype.str[1:]
            vdims = ds.var_dims(n)
            vid = ctypes.c_int()
            darr = (ctypes.c_int * len(vdims))(*[dimids[d] for d in vdims])
            _check(lib.nc_def_var(ncid, n.encode(), _NCT[key], len(vdims),
                                  darr, ctypes.byref(vid)), f"var {n}")
            vids[n] = vid.value
            put_atts(vid.value, ds.var_attrs(n))
        put_atts(NC_GLOBAL,
                 {k: ds.get_attr(k) for k in ds.global_attr_names()})
        _check(lib.nc_enddef(ncid), "enddef")
        for n in names:
            a = np.ascontiguousarray(np.asarray(ds.read_var(n)))
            start = (ctypes.c_size_t * a.ndim)(*([0] * a.ndim))
            cnt = (ctypes.c_size_t * a.ndim)(*a.shape)
            if a.dtype.kind == "S":
                _check(lib.nc_put_vara_text(ncid, vids[n], start, cnt,
                                            a.tobytes()), f"put {n}")
            else:
                fn, ct = _PUT[a.dtype.str[1:]]
                _check(getattr(lib, fn)(
                    ncid, vids[n], start, cnt,
                    a.ctypes.data_as(ctypes.POINTER(ct))), f"put {n}")
        _check(lib.nc_close(ncid), "close")


def test_pipeline_on_cdf5_inputs(tmp_path):
    """Full pipeline on CDF-5 grid/diag/hist inputs (the format large
    production MPAS runs write) — results bit-identical to the same inputs
    in NetCDF4/HDF5. Covers mesh build (mesh/mpas.py), field reads
    (io/mpas_reader.py), xtime, and the scheme-code global attrs through
    the pure-Python CDF-5 parser."""
    import jax.numpy as jnp

    from test_pipeline import make_case

    from mpassit_jax.run.pipeline import run_pipeline

    mesh, cfg, _, _ = make_case(tmp_path)
    art_h5 = run_pipeline(cfg, dtype=jnp.float32)
    c5 = tmp_path / "cdf5"
    c5.mkdir()
    for f in ("grid.nc", "diag.nc", "hist.nc"):
        _to_cdf5(tmp_path / f, c5 / f)
    cfg.grid_file_input_grid = str(c5 / "grid.nc")
    cfg.diag_file_input_grid = str(c5 / "diag.nc")
    cfg.hist_file_input_grid = str(c5 / "hist.nc")
    cfg.output_file = str(tmp_path / "out_cdf5.nc")
    art_c5 = run_pipeline(cfg, dtype=jnp.float32)
    for cat in ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d", "vert3d",
                "cons2d", "nstd2d", "soil"):
        for (na, a, *_), (nb, b, *_) in zip(
                getattr(art_h5.result, cat) or [],
                getattr(art_c5.result, cat) or []):
            assert na == nb
            np.testing.assert_array_equal(a, b, err_msg=f"{cat}.{na}")
    np.testing.assert_array_equal(art_h5.result.u, art_c5.result.u)
    np.testing.assert_array_equal(art_h5.result.v, art_c5.result.v)
    assert art_h5.data.start_time == art_c5.data.start_time


def test_cdf5_single_record_var_unpadded(tmp_path):
    """Spec corner: ONE record variable of a sub-4-byte type has NO
    inter-record padding — the record stride is the raw slice size."""
    lib = _lib()
    p = tmp_path / "s.nc"
    ncid = ctypes.c_int()
    _check(lib.nc_create(str(p).encode(), NC_CLOBBER | NC_64BIT_DATA,
                         ctypes.byref(ncid)), "create")
    d_t, d_x = ctypes.c_int(), ctypes.c_int()
    _check(lib.nc_def_dim(ncid, b"Time", NC_UNLIMITED, ctypes.byref(d_t)),
           "dim")
    _check(lib.nc_def_dim(ncid, b"x", 3, ctypes.byref(d_x)), "dim")
    vid = ctypes.c_int()
    dims = (ctypes.c_int * 2)(d_t.value, d_x.value)
    _check(lib.nc_def_var(ncid, b"c", NC_SHORT, 2, dims,
                          ctypes.byref(vid)), "def")
    _check(lib.nc_enddef(ncid), "enddef")
    vals = np.arange(12, dtype=np.int16).reshape(4, 3)
    start = (ctypes.c_size_t * 2)(0, 0)
    cnt = (ctypes.c_size_t * 2)(4, 3)
    _check(lib.nc_put_vara_short(
        ncid, vid, start, cnt,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_short))), "put")
    _check(lib.nc_close(ncid), "close")
    with open_dataset(str(p)) as ds:
        np.testing.assert_array_equal(ds.read_var("c"), vals)
