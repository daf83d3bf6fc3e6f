"""Minimal NetCDF reader/writer (no netCDF4/xarray needed).

Replaces the functionality the reference consumes from netcdf-fortran/NetCDF-C
(SURVEY §2.3): ``nf90_open/inq/get_var/get_att`` for input and
``nf90_create/def_dim/def_var/put_att/put_var`` for output
(write_data.F90:173-997).

- Classic-format files — CDF-1, CDF-2 (64-bit offset, what WRF writes) and
  CDF-5 (the 64-bit-data variant production MPAS runs write for >4 GiB
  variables) — are read and written by ``ClassicFile`` below with numpy
  alone: the header is parsed or built in Python and variable data is
  mapped with ``mmap``. The output writer produces CDF-2.
- NetCDF4 files are HDF5; they are read (and, for test fixtures, written)
  through h5py using the standard netCDF4-on-HDF5 conventions (dimension
  scales, ``_Netcdf4Dimid``, ``DIMENSION_LIST``). h5py is imported only
  for such files; without it, opening one raises a FatalError.
"""

from __future__ import annotations

import mmap

import numpy as np


def _decode(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        if v.ndim == 0:
            return _decode(v[()])
        if v.size == 1:
            return _decode(v.reshape(-1)[0])
        return v
    if isinstance(v, np.generic):
        return v.item() if not isinstance(v, np.bytes_) else v.item().decode()
    return v


# ---- classic format (CDF-1/2/5) --------------------------------------------
# Spec: the netCDF "classic format" grammar (CDF-1/CDF-2) and the pnetcdf
# CDF-5 specification — CDF-2 widens the variable ``begin`` offsets to
# int64; CDF-5 further widens every NON_NEG count/size (numrecs, nelems,
# name lengths, dim lengths, dimids, vsize) to int64 and adds the
# unsigned/64-bit external types. All values are big-endian.

_NC_TYPES = {
    1: ("b", 1), 2: ("S1", 1), 3: (">i2", 2), 4: (">i4", 4),
    5: (">f4", 4), 6: (">f8", 8), 7: ("u1", 1), 8: (">u2", 2),
    9: (">u4", 4), 10: (">i8", 8), 11: (">u8", 8),
}
#: numpy dtype -> external type, for the CDF-2 types the writer emits
_NC_TYPE_OF = {np.dtype("i1"): 1, np.dtype("S1"): 2, np.dtype("i2"): 3,
               np.dtype("i4"): 4, np.dtype("f4"): 5, np.dtype("f8"): 6}
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = 0x0A, 0x0B, 0x0C
_VSIZE_MAX = 2 ** 32 - 1          # CDF-2 vsize of a variable past 4 GiB


def _pad4(n):
    return n + ((-n) % 4)


class ClassicFile:
    """Classic-format NetCDF file.

    ``mode="r"`` reads CDF-1/2/5 (the reader protocol shared with
    ``NetCDF4File``); ``"r+"`` also writes variables of an existing file in
    place; ``"w"`` creates a CDF-2 file through the same define-mode calls
    as ``NetCDF4File`` (create_dim / set_attr / create_var). The header is
    written at the first data write or at close (``enddef``); data given
    to ``create_var`` before that is written then. The file is created in
    no-fill mode: values never written read back as 0. Variable data is
    reached through ``mmap``, so reads and writes touch only the bytes of
    the variable concerned."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._fh = None
        self._buf = None
        if mode == "w":
            self.version = 2
            self.dims = []            # [(name, length)]; length 0 = record
            self.numrecs = 0
            self._gatts = {}
            self.vars = {}            # name -> dict (see create_var)
            self._pending = {}        # name -> data (array or callable)
            self._fills = {}          # name -> nonzero fill scalar
            self._defining = True
            open(path, "wb").close()  # truncate / create now, like nc_create
            return
        if mode not in ("r", "r+"):
            raise ValueError(f"unsupported mode {mode!r}")
        self._defining = False
        self._fh = open(path, "rb" if mode == "r" else "r+b")
        try:
            access = mmap.ACCESS_READ if mode == "r" else mmap.ACCESS_WRITE
            self._buf = mmap.mmap(self._fh.fileno(), 0, access=access)
            self._parse_header()
        except BaseException:
            self.close()
            raise

    # -- header parsing ---------------------------------------------------
    def _int(self, pos, n):
        return int.from_bytes(self._buf[pos:pos + n], "big"), pos + n

    def _nn(self, pos):
        return self._int(pos, self._nn_w)

    def _name(self, pos):
        n, pos = self._nn(pos)
        s = self._buf[pos:pos + n].decode("utf-8", "replace")
        return s, pos + _pad4(n)

    def _parse_header(self):
        magic = self._buf[:4]
        if magic[:3] != b"CDF" or magic[3] not in (1, 2, 5):
            raise ValueError(f"{self.path}: not a classic NetCDF file")
        self.version = magic[3]
        self._nn_w = 8 if self.version == 5 else 4
        self._off_w = 4 if self.version == 1 else 8
        numrecs, pos = self._nn(4)
        self.dims, pos = self._dim_list(pos)
        self._gatts, pos = self._att_list(pos)
        self.vars, pos = self._var_list(pos)
        self._layout_records()
        if numrecs == 2 ** (8 * self._nn_w) - 1:       # STREAMING
            rec = [v for v in self.vars.values() if v["record"]]
            numrecs = ((len(self._buf) - min(v["begin"] for v in rec))
                       // self._recsize if rec and self._recsize else 0)
        self.numrecs = numrecs

    def _dim_list(self, pos):
        _, pos = self._int(pos, 4)
        n, pos = self._nn(pos)
        dims = []
        for _ in range(n):
            name, pos = self._name(pos)
            ln, pos = self._nn(pos)
            dims.append((name, ln))
        return dims, pos

    def _att_list(self, pos):
        _, pos = self._int(pos, 4)
        n, pos = self._nn(pos)
        atts = {}
        for _ in range(n):
            name, pos = self._name(pos)
            nct, pos = self._int(pos, 4)
            ne, pos = self._nn(pos)
            dt, sz = _NC_TYPES[nct]
            raw = self._buf[pos:pos + ne * sz]
            pos += _pad4(ne * sz)
            if nct == 2:
                atts[name] = raw.decode("utf-8", "replace")
            else:
                a = np.frombuffer(raw, dt)
                atts[name] = a.item() if a.size == 1 else a
        return atts, pos

    def _var_list(self, pos):
        _, pos = self._int(pos, 4)
        n, pos = self._nn(pos)
        out = {}
        for _ in range(n):
            name, pos = self._name(pos)
            rank, pos = self._nn(pos)
            dimids = []
            for _ in range(rank):
                d, pos = self._nn(pos)
                dimids.append(d)
            atts, pos = self._att_list(pos)
            nct, pos = self._int(pos, 4)
            vsize, pos = self._nn(pos)
            begin, pos = self._int(pos, self._off_w)
            out[name] = dict(dimids=dimids, atts=atts, nc_type=nct,
                             vsize=vsize, begin=begin)
        return out, pos

    def _layout_records(self):
        """Per-variable slab shapes and the record stride. The record size
        is the sum of the record variables' vsizes, except that a single
        record variable is not padded (spec: no inter-record padding)."""
        for v in self.vars.values():
            shape = [self.dims[d][1] for d in v["dimids"]]
            v["record"] = bool(shape) and shape[0] == 0
            v["slab"] = shape[1:] if v["record"] else shape
        rec = [v for v in self.vars.values() if v["record"]]
        self._recsize = sum(_pad4(self._slab_bytes(v)) for v in rec)
        if len(rec) == 1:
            self._recsize = self._slab_bytes(rec[0])

    @staticmethod
    def _slab_bytes(v):
        return int(np.prod(v["slab"], dtype=np.int64)) * \
            _NC_TYPES[v["nc_type"]][1]

    # -- reader protocol --------------------------------------------------
    def close(self):
        if self.mode == "w" and self._defining:
            self.enddef()
        if self._buf is not None:
            if self.mode != "r":
                self._buf.flush()
            self._buf.close()
            self._buf = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def has_dim(self, name):
        return any(nm == name for nm, _ in self.dims)

    def dim_names(self):
        return [nm for nm, _ in self.dims]

    def dim_size(self, name: str) -> int:
        ln = dict(self.dims)[name]
        return self.numrecs if ln == 0 else ln

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def var_names(self):
        return list(self.vars)

    def var_dims(self, name: str):
        return [self.dims[d][0] for d in self.vars[name]["dimids"]]

    def var_view(self, name: str) -> np.ndarray:
        """The variable's data as an array over the mapped file, no copy
        (big-endian, as stored); writable in modes "r+" and "w"."""
        if self._defining:
            self.enddef()
        v = self.vars[name]
        dt = np.dtype(_NC_TYPES[v["nc_type"]][0])
        if not v["record"]:
            return np.ndarray(v["slab"], dt, self._buf, v["begin"])
        slab = v["slab"]
        inner = np.ndarray(slab, dt).strides if slab else ()
        return np.ndarray([self.numrecs] + slab, dt, self._buf, v["begin"],
                          strides=(self._recsize,) + inner)

    def read_var(self, name: str):
        """An owned, native-byte-order copy (a view would pin the mmap and
        make close() raise)."""
        v = self.var_view(name)
        return v.astype(v.dtype.newbyteorder("="))

    def var_attrs(self, name: str):
        return dict(self.vars[name]["atts"])

    def get_attr(self, name: str, default=KeyError):
        try:
            return self._gatts[name]
        except KeyError:
            if default is KeyError:
                raise
            return default

    def global_attr_names(self):
        return list(self._gatts)

    # -- writer (define mode, CDF-2) --------------------------------------
    def create_dim(self, name: str, size: int | None):
        """def_dim: size=None -> the unlimited (record) dimension."""
        self.dims.append((name, 0 if size is None else int(size)))

    def ensure_unlimited_size(self, name: str, size: int):
        self.numrecs = max(self.numrecs, int(size))

    def set_attr(self, name: str, value, var: str | None = None):
        """put_att: str -> NC_CHAR (the type netcdf-fortran writes for
        character data), int -> NC_INT, float -> NC_DOUBLE, arrays by
        dtype."""
        if not self._defining:
            raise ValueError("attributes can only be set in define mode")
        target = self._gatts if var is None else self.vars[var]["atts"]
        if isinstance(value, (int, np.integer)) and not isinstance(
                value, bool):
            value = np.int32(value)
        elif isinstance(value, float):
            value = np.float64(value)
        target[name] = value

    def create_var(self, name: str, dims, dtype, data=None, fill=None):
        """def_var, with an optional put_var at enddef: ``data`` is an
        array or a zero-argument callable returning one (evaluated only
        when written, so a caller need not hold every variable at once);
        ``fill`` is a scalar written to every element instead."""
        dt = np.dtype(dtype)
        if dt not in _NC_TYPE_OF:
            raise ValueError(f"{name}: dtype {dt} has no CDF-2 type")
        dimids = [self.dim_names().index(d) for d in dims]
        self.vars[name] = dict(dimids=dimids, atts={},
                               nc_type=_NC_TYPE_OF[dt])
        if data is not None:
            self._pending[name] = data
        elif fill is not None and fill != 0:
            self._fills[name] = fill

    def enddef(self):
        """Lay out and write the header, size the file, map it, and write
        the data given at definition."""
        self._defining = False
        self._nn_w, self._off_w = 4, 8
        self._layout_records()
        header_len = len(self._header_bytes())   # begins don't change it
        pos = header_len
        for v in self.vars.values():
            if not v["record"]:
                v["begin"] = pos
                pos += _pad4(self._slab_bytes(v))
        for v in self.vars.values():
            if v["record"]:
                v["begin"] = pos
                pos += _pad4(self._slab_bytes(v))
        for v in self.vars.values():
            v["vsize"] = min(_pad4(self._slab_bytes(v)), _VSIZE_MAX)
        rec = [v["begin"] for v in self.vars.values() if v["record"]]
        end = max([header_len] + [
            v["begin"] + self._slab_bytes(v)
            for v in self.vars.values() if not v["record"]] + [
            min(rec) + self._recsize * self.numrecs if rec else 0])
        self._fh = open(self.path, "r+b")
        self._fh.write(self._header_bytes())
        self._fh.truncate(end)
        self._fh.flush()
        self._buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_WRITE)
        for name, fill in self._fills.items():
            self.var_view(name)[...] = fill
        pending, self._pending = self._pending, {}
        for name, data in pending.items():
            self.write_var(name, data() if callable(data) else data)

    def _header_bytes(self):
        def nn(n):
            return int(n).to_bytes(4, "big")

        def name(s):
            b = s.encode()
            return nn(len(b)) + b + b"\0" * ((-len(b)) % 4)

        def atts(d):
            if not d:
                return nn(0) + nn(0)
            out = [nn(_NC_ATTRIBUTE), nn(len(d))]
            for k, val in d.items():
                if isinstance(val, (str, bytes)):
                    raw = val.encode() if isinstance(val, str) else val
                    nct, ne = 2, len(raw)
                else:
                    a = np.asarray(val).reshape(-1)
                    nct = _NC_TYPE_OF[a.dtype.newbyteorder("=")]
                    raw = a.astype(_NC_TYPES[nct][0]).tobytes()
                    ne = a.size
                out += [name(k), nn(nct), nn(ne), raw,
                        b"\0" * ((-len(raw)) % 4)]
            return b"".join(out)

        out = [b"CDF\x02", nn(self.numrecs)]
        if self.dims:
            out += [nn(_NC_DIMENSION), nn(len(self.dims))]
            out += [name(d) + nn(ln) for d, ln in self.dims]
        else:
            out += [nn(0), nn(0)]
        out.append(atts(self._gatts))
        if self.vars:
            out += [nn(_NC_VARIABLE), nn(len(self.vars))]
            for vn, v in self.vars.items():
                out += [name(vn), nn(len(v["dimids"]))]
                out += [nn(d) for d in v["dimids"]]
                out += [atts(v["atts"]), nn(v["nc_type"]),
                        nn(v.get("vsize", 0)),
                        int(v.get("begin", 0)).to_bytes(8, "big")]
        else:
            out += [nn(0), nn(0)]
        return b"".join(out)

    def write_var(self, name: str, data):
        """put_var of the whole variable (in define mode: at enddef)."""
        if self._defining:
            self._pending[name] = data
            return
        view = self.var_view(name)
        data = np.asarray(data)
        if view.dtype.kind == "S":
            data = data.astype("S1")
        view[...] = data.reshape(view.shape)

    def write_var_slab(self, name: str, data, starts):
        """Partial put_var: write ``data`` at offset vector ``starts``
        (the nf90_put_var start/count form — the streaming writer fills
        variables level-block by level-block as strips arrive)."""
        view = self.var_view(name)
        sel = tuple(slice(s, s + n) for s, n in zip(starts, np.shape(data)))
        view[sel] = data


_NC_DIM_NAME = "This is a netCDF dimension but not a netCDF variable. %10d"


def _h5py():
    """h5py, imported on first use: only NetCDF4/HDF5 files need it."""
    try:
        import h5py
    except ImportError as e:
        from ..errors import FatalError

        raise FatalError(
            "READING OR WRITING A NETCDF4/HDF5 FILE NEEDS THE PYTHON "
            "PACKAGE h5py, WHICH IS NOT INSTALLED") from e
    return h5py


def _decode_h5(v):
    if isinstance(v, _h5py().Empty):  # null dataspace = zero-length text
        return ""
    return _decode(v)


class NetCDF4File:
    """NetCDF4 (HDF5-backed) file with a small reader/writer API."""

    def __init__(self, path: str, mode: str = "r"):
        h5py = _h5py()

        self.path = path
        self.mode = mode
        # track_order: netCDF-C enumerates dims/vars/attrs in creation order
        # (HDF5 link/attr creation-order indexes); without it h5py defaults
        # to name order and nc_inq_dimname(0) would return the alphabetically
        # first dim instead of the first-defined one.
        if mode in ("w", "w-", "x"):
            self._f = h5py.File(path, mode, track_order=True)
            # netCDF-C stamps every file it creates with _NCProperties
            # (libhdf5 superblock attr); real consumers (ncdump, UPP) carry
            # it through, so we write the same marker.
            self._f.attrs["_NCProperties"] = np.bytes_(
                b"version=2,netcdf=4.9.0,hdf5=1.10.8")
        else:
            self._f = h5py.File(path, mode)
        self._dimids: dict[str, int] = {}
        if mode == "r":
            for name, ds in self._f.items():
                if self._is_dim(ds):
                    self._dimids[name] = len(self._dimids)

    # -- common ------------------------------------------------------------

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @staticmethod
    def _is_dim(ds) -> bool:
        return isinstance(ds, _h5py().Dataset) and ds.attrs.get("CLASS") == b"DIMENSION_SCALE"

    # -- reading -----------------------------------------------------------

    def has_dim(self, name: str) -> bool:
        return name in self._f and self._is_dim(self._f[name])

    def dim_names(self):
        return list(self._dimids)

    def dim_size(self, name: str) -> int:
        return self._f[name].shape[0]

    def has_var(self, name: str) -> bool:
        if name not in self._f:
            return False
        ds = self._f[name]
        if not self._is_dim(ds):
            return True
        # a coordinate variable is both a dim and a variable
        return ds.attrs.get("NAME", b"").startswith(b"%s" % name.encode())

    def var_names(self):
        out = []
        for name, ds in self._f.items():
            if isinstance(ds, _h5py().Dataset) and self.has_var(name):
                out.append(name)
        return out

    def var_dims(self, name: str):
        ds = self._f[name]
        out = []
        for i in range(ds.ndim):
            proxy = ds.dims[i]
            out.append(proxy[0].name.lstrip("/") if len(proxy) else None)
        return out

    def read_var(self, name: str):
        return np.asarray(self._f[name][...])

    def var_attrs(self, name: str):
        return {
            k: _decode_h5(v)
            for k, v in self._f[name].attrs.items()
            if not k.startswith("_Netcdf4") and k not in ("CLASS", "NAME", "DIMENSION_LIST", "REFERENCE_LIST")
        }

    def get_attr(self, name: str, default=KeyError):
        try:
            return _decode_h5(self._f.attrs[name])
        except KeyError:
            if default is KeyError:
                raise
            return default

    def global_attr_names(self):
        return [k for k in self._f.attrs if not k.startswith("_NC")]

    # -- writing -----------------------------------------------------------

    def set_attr(self, name: str, value, var: str | None = None):
        target = self._f if var is None else self._f[var]
        if isinstance(value, str):
            # fixed-length bytes -> netCDF-C sees NC_CHAR (text) attrs, the
            # type netcdf-fortran writes (nf90_put_att with character data);
            # h5py's default str mapping would surface as NC_STRING instead.
            # Empty strings use a null dataspace (how netCDF-C stores
            # zero-length text attrs, e.g. stagger="" on mass-point vars).
            if value == "":
                target.attrs[name] = _h5py().Empty(np.dtype("S1"))
            else:
                target.attrs[name] = np.bytes_(value.encode())
        elif isinstance(value, (int, np.integer)):
            target.attrs[name] = np.int32(value)
        elif isinstance(value, float):
            target.attrs[name] = np.float64(value)
        else:
            target.attrs[name] = value

    def create_dim(self, name: str, size: int | None):
        """def_dim: size=None -> unlimited (current size grows on write)."""
        if size is None:
            ds = self._f.create_dataset(name, shape=(0,), maxshape=(None,),
                                        dtype="f4", track_order=True)
        else:
            ds = self._f.create_dataset(name, shape=(size,), dtype="f4",
                                        track_order=True)
        ds.make_scale(_NC_DIM_NAME % (0 if size is None else size))
        ds.attrs["_Netcdf4Dimid"] = np.int32(len(self._dimids))
        self._dimids[name] = len(self._dimids)
        return ds

    def ensure_unlimited_size(self, name: str, size: int):
        ds = self._f[name]
        if ds.shape[0] < size:
            ds.resize((size,))

    def create_var(self, name: str, dims, dtype, data=None, fill=None,
                   compress: bool = False):
        """def_var + optional immediate put_var. dims are dimension names."""
        shape = tuple(self._f[d].shape[0] for d in dims)
        kwargs = {}
        if compress:
            kwargs.update(compression="gzip", compression_opts=1, shuffle=True)
        ds = self._f.create_dataset(name, shape=shape, dtype=dtype,
                                    track_order=True, **kwargs)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._f[d])
        ds.attrs["_Netcdf4Coordinates"] = np.array(
            [self._dimids[d] for d in dims], dtype=np.int32
        )
        if data is not None:
            ds[...] = data
        elif fill is not None:
            ds[...] = fill
        return ds

    def write_var(self, name: str, data):
        self._f[name][...] = data

    def write_var_slab(self, name: str, data, starts):
        """Partial put_var: write ``data`` at offset vector ``starts``
        (the nf90_put_var start/count form — the streaming writer fills
        variables level-block by level-block as strips arrive)."""
        ds = self._f[name]
        sel = tuple(slice(s, s + n) for s, n in zip(starts, np.shape(data)))
        ds[sel] = data


def open_dataset(path: str):
    """nf90_open equivalent: dispatch on the file magic (classic CDF-1/2/5
    vs HDF5)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF" and magic[3:4] in (b"\x01", b"\x02", b"\x05"):
        return ClassicFile(path)
    # HDF5 (its superblock may also sit at an offset: let h5py decide)
    return NetCDF4File(path, "r")
