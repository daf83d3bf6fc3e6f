"""The classic CDF-2 writer (io/nc4.ClassicFile) checked by an independent
reader, scipy.io.netcdf_file: every external type, the unlimited Time
dimension, char arrays, attributes, and slab-by-slab (streamed) writes
giving the same bytes as whole-variable writes."""

import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from mpassit_jax.io.nc4 import ClassicFile, open_dataset


def _read_scipy(path):
    f = netcdf_file(path, "r", mmap=False)
    try:
        return ({k: np.array(v[...]) for k, v in f.variables.items()},
                dict(f._attributes), dict(f.dimensions), f.version_byte,
                {k: dict(v._attributes) for k, v in f.variables.items()})
    finally:
        f.close()


@pytest.mark.parametrize("dtype", ["i1", "S1", "i2", "i4", "f4", "f8"])
def test_each_external_type(tmp_path, dtype):
    p = str(tmp_path / "t.nc")
    rng = np.random.default_rng(3)
    if dtype == "S1":
        data = np.frombuffer(b"abcdefghijkl", "S1").reshape(3, 4)
    elif dtype.startswith("f"):
        data = rng.standard_normal((3, 4)).astype(dtype)
    else:
        data = rng.integers(-100, 100, (3, 4)).astype(dtype)
    with ClassicFile(p, "w") as f:
        f.create_dim("y", 3)
        f.create_dim("x", 4)
        f.create_var("v", ("y", "x"), dtype, data=data)
    vars_, _, dims, version, _ = _read_scipy(p)
    assert version == 2 and dims == {"y": 3, "x": 4}
    np.testing.assert_array_equal(vars_["v"], data)
    with open_dataset(p) as f:
        got = f.read_var("v")
        assert got.dtype.isnative or got.dtype.itemsize == 1
        np.testing.assert_array_equal(got, data)


def test_unlimited_time_records(tmp_path):
    """Several record variables (one of a sub-4-byte type, padded) over
    three records, next to a fixed variable."""
    p = str(tmp_path / "rec.nc")
    a = np.arange(3 * 5, dtype=np.float32).reshape(3, 5)
    b = np.arange(3 * 3, dtype=np.int16).reshape(3, 3)
    c = np.arange(4, dtype=np.float64)
    with ClassicFile(p, "w") as f:
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 3)
        f.create_dim("x", 5)
        f.create_dim("z", 3)
        f.create_dim("n", 4)
        f.create_var("a", ("Time", "x"), "f4", data=a)
        f.create_var("b", ("Time", "z"), "i2", data=b)
        f.create_var("c", ("n",), "f8", data=c)
    vars_, _, dims, _, _ = _read_scipy(p)
    assert dims["Time"] is None
    for k, want in (("a", a), ("b", b), ("c", c)):
        np.testing.assert_array_equal(vars_[k], want)
    # the same schema written by scipy has the same length: the file ends
    # after the last record (scipy orders the header differently)
    q = str(tmp_path / "rec_scipy.nc")
    f = netcdf_file(q, "w", version=2)
    for d, n in (("Time", None), ("x", 5), ("z", 3), ("n", 4)):
        f.createDimension(d, n)
    for k, t, dims_k, want in (("a", "f", ("Time", "x"), a),
                               ("b", "h", ("Time", "z"), b),
                               ("c", "d", ("n",), c)):
        f.createVariable(k, t, dims_k)[:] = want
    f.close()
    assert os.path.getsize(p) == os.path.getsize(q)
    with open_dataset(p) as f:
        assert f.dim_size("Time") == 3
        assert f.var_dims("b") == ["Time", "z"]
        np.testing.assert_array_equal(f.read_var("b"), b)


def test_char_array_and_attributes(tmp_path):
    p = str(tmp_path / "att.nc")
    times = np.frombuffer(b"2024-03-25_10:00:00", "S1")[None]
    with ClassicFile(p, "w") as f:
        f.create_dim("Time", None)
        f.ensure_unlimited_size("Time", 1)
        f.create_dim("StrLen", 19)
        f.set_attr("TITLE", "OUTPUT FROM MPASSIT")
        f.set_attr("MAP_PROJ", 1)
        f.set_attr("DX", 3000.0)
        f.create_var("Times", ("Time", "StrLen"), "S1", data=times)
        f.set_attr("stagger", "", var="Times")
        f.set_attr("levels", np.arange(3, dtype=np.float32), var="Times")
    vars_, gatts, _, _, vatts = _read_scipy(p)
    assert vars_["Times"].tobytes() == b"2024-03-25_10:00:00"
    assert gatts["TITLE"] == b"OUTPUT FROM MPASSIT"
    assert gatts["MAP_PROJ"] == 1 and gatts["MAP_PROJ"].dtype == np.int32
    assert gatts["DX"] == 3000.0 and gatts["DX"].dtype == np.float64
    assert vatts["Times"]["stagger"] == b""
    np.testing.assert_array_equal(vatts["Times"]["levels"], [0, 1, 2])
    with open_dataset(p) as f:
        assert f.get_attr("TITLE") == "OUTPUT FROM MPASSIT"
        assert f.get_attr("MAP_PROJ") == 1
        assert f.var_attrs("Times")["stagger"] == ""


def test_streamed_slabs_equal_whole_write(tmp_path):
    """Level-by-level write_var_slab (the streaming writer's pattern),
    a callable given at definition, and a fill all give the bytes of a
    whole-array write."""
    rng = np.random.default_rng(5)
    t3 = rng.standard_normal((1, 4, 6, 7)).astype(np.float32)
    paths = []
    for mode in ("whole", "slabs"):
        p = str(tmp_path / f"{mode}.nc")
        with ClassicFile(p, "w") as f:
            f.create_dim("Time", None)
            f.ensure_unlimited_size("Time", 1)
            for d, n in (("z", 4), ("y", 6), ("x", 7)):
                f.create_dim(d, n)
            dims = ("Time", "z", "y", "x")
            if mode == "whole":
                f.create_var("T", dims, "f4", data=lambda: t3)
                f.create_var("F", dims, "f4",
                             data=np.full(t3.shape, 2.5, np.float32))
                f.create_var("Z", ("Time", "y", "x"), "f4",
                             data=np.zeros((1, 6, 7), np.float32))
            else:
                f.create_var("T", dims, "f4")
                f.create_var("F", dims, "f4", fill=2.5)
                f.create_var("Z", ("Time", "y", "x"), "f4", fill=0.0)
                f.enddef()
                for k in range(4):
                    f.write_var_slab("T", t3[:, k:k + 1], (0, k, 0, 0))
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    vars_, *_ = _read_scipy(paths[1])
    np.testing.assert_array_equal(vars_["T"], t3)


def test_in_place_edit(tmp_path):
    """Mode r+ edits one value of an existing file in place."""
    p = str(tmp_path / "e.nc")
    with ClassicFile(p, "w") as f:
        f.create_dim("x", 3)
        f.create_var("v", ("x",), "f4", data=np.zeros(3, np.float32))
    with ClassicFile(p, "r+") as f:
        f.var_view("v")[1] = 7.0
    vars_, *_ = _read_scipy(p)
    np.testing.assert_array_equal(vars_["v"], [0.0, 7.0, 0.0])


def test_rejects_types_outside_cdf2(tmp_path):
    with ClassicFile(str(tmp_path / "x.nc"), "w") as f:
        f.create_dim("x", 2)
        with pytest.raises(ValueError, match="CDF-2"):
            f.create_var("v", ("x",), "i8")
