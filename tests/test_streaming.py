"""Streaming output (VERDICT r3 item 2): stream_output=.true. writes each
fetched strip straight into the NetCDF file through a writer thread.

The contract: the streamed file is IDENTICAL to the in-memory path's file
— same variables in the same order, same attributes, bit-identical data
(transforms run at f64 in both paths) — while the host never materializes
the full output block.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mpassit_jax.io.nc4 import open_dataset
from mpassit_jax.run.pipeline import run_pipeline

from test_pipeline import make_case


@pytest.fixture(scope="module", params=["lambert", "latlon-regional"])
def pair(tmp_path_factory, request):
    """Run the same case through both writers; return the two file paths.
    Lambert exercises the rotation paths (in-kernel tags + deferred
    U10/V10); lat-lon the rotation-free ones."""
    d1 = tmp_path_factory.mktemp("inmem")
    d2 = tmp_path_factory.mktemp("stream")
    over = {}
    if request.param == "latlon-regional":
        over = {"target_grid_type": "lat-lon", "dx": 1.8, "dy": 1.5,
                "truelat1": None, "stand_lon": None}
    mesh, cfg1, _, _ = make_case(d1, cfg_overrides=over)
    run_pipeline(cfg1, dtype=jnp.float32)
    mesh, cfg2, _, _ = make_case(d2, cfg_overrides=over)
    cfg2.stream_output = True
    art2 = run_pipeline(cfg2, dtype=jnp.float32)
    # streaming never materialized the big categories
    assert art2.result.diag2d == [] and art2.result.nz3d == []
    return cfg1.output_file, cfg2.output_file


def test_streamed_file_identical(pair):
    ref_path, got_path = pair
    with open_dataset(ref_path) as a, open_dataset(got_path) as b:
        assert a.var_names() == b.var_names()      # same vars, same order
        assert a.dim_names() == b.dim_names()
        ga, gb = a.global_attr_names(), b.global_attr_names()
        assert ga == gb
        for k in ga:
            va, vb = a.get_attr(k), b.get_attr(k)
            assert np.array_equal(va, vb), (k, va, vb)
        for name in a.var_names():
            assert a.var_dims(name) == b.var_dims(name), name
            aa, ab = a.var_attrs(name), b.var_attrs(name)
            assert aa == ab, (name, aa, ab)
            x = np.asarray(a.read_var(name))
            y = np.asarray(b.read_var(name))
            if x.dtype.kind == "f":
                assert np.array_equal(x, y, equal_nan=True), name
            else:
                assert np.array_equal(x, y), name


def test_streamed_namelist_roundtrip(tmp_path):
    """stream_output is namelist-reachable and the streamed file is
    readable end to end."""
    mesh, cfg, _, _ = make_case(tmp_path)
    cfg.stream_output = True
    run_pipeline(cfg, dtype=jnp.float32)
    with open_dataset(cfg.output_file) as f:
        t = np.asarray(f.read_var("T"))
        assert np.isfinite(t).all()
        ptop = np.asarray(f.read_var("P_TOP"))
        assert ptop.shape == (1,) and np.isfinite(ptop).all()


def test_put_raises_instead_of_hanging_when_writer_dies():
    """ADVICE r4 #2: if the writer thread dies (e.g. disk full) while the
    bounded queue is full, put()/finish() must raise the write error, not
    block forever."""
    import queue
    import threading
    import time

    from mpassit_jax.io.wrf_writer import StreamingWriter

    w = StreamingWriter.__new__(StreamingWriter)
    w._exc = None
    w.stats = {"t_write_s": 0.0, "t_block_s": 0.0, "blocks": 0}
    w._q = queue.Queue(maxsize=1)
    calls = []

    def boom(var, lev0, block):
        calls.append(var)
        time.sleep(0.05)            # let the producer fill the queue
        raise OSError("disk full")

    w._write_block = boom
    w._thread = threading.Thread(target=w._drain, daemon=True)
    w._thread.start()
    blk = np.zeros((2, 2), np.float32)
    t0 = time.monotonic()
    with pytest.raises(OSError, match="disk full"):
        # first put is consumed (and errors); keep putting until the death
        # is observed — each call must return promptly, never deadlock
        for _ in range(50):
            w.put("X", 0, blk)
            time.sleep(0.01)
    assert time.monotonic() - t0 < 10.0
    with pytest.raises(OSError, match="disk full"):
        w.finish()


@pytest.mark.parametrize("cb,fetch", [(3, 6), (7, 512)])
def test_streamed_seams_multiple_strips_per_var(tmp_path, monkeypatch,
                                                cb, fetch):
    """VERDICT r4 item 7: force the fetch strip width BELOW nz so every
    3-D variable (incl. PHB/Z_C stitching and the P_HYD top level feeding
    P_TOP) spans several strips with odd level boundaries; the streamed
    file must stay bit-identical to the in-memory writer's
    (write_data.F90:1362-1419 transforms)."""
    import mpassit_jax.ops.matmul_apply as ma

    # CB is patched for BOTH runs: the column blocking changes XLA's
    # summation shapes (last-ulp apply differences), so bit-identity is
    # only defined between same-CB runs — the seam logic under test lives
    # in _StripRouter/StreamingWriter, which only the streamed run uses
    monkeypatch.setattr(ma, "CB", cb)
    monkeypatch.setattr(ma, "FETCH", fetch)
    d1 = tmp_path / "inmem"; d1.mkdir()
    mesh, cfg1, _, _ = make_case(d1, nz=5)
    run_pipeline(cfg1, dtype=jnp.float32)

    d2 = tmp_path / "stream"; d2.mkdir()
    mesh, cfg2, _, _ = make_case(d2, nz=5)
    cfg2.stream_output = True
    run_pipeline(cfg2, dtype=jnp.float32)

    with open_dataset(cfg1.output_file) as a, \
            open_dataset(cfg2.output_file) as b:
        assert a.var_names() == b.var_names()
        for name in a.var_names():
            x = np.asarray(a.read_var(name))
            y = np.asarray(b.read_var(name))
            if x.dtype.kind == "f":
                assert np.array_equal(x, y, equal_nan=True), name
            else:
                assert np.array_equal(x, y), name
