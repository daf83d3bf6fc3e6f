"""SlabMatmulRegridder (ops/matmul_apply.py) contracts on real weights:
parity vs the independent gather Regridder, the documented precision error
bounds, the load-bearing optimization_barrier in _split_hilo, and the
LANE(128) column padding / CB chunking behavior."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpassit_jax.mesh.reorder import reorder_cells_morton
from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_jax.ops.apply import Regridder
from mpassit_jax.ops.matmul_apply import (
    CB,
    LANE,
    SlabMatmulRegridder,
    _split_hilo,
)
from mpassit_jax.weights.bilinear import bilinear_cell_weights

from test_weights import coarse_lambert_grid


@pytest.fixture(scope="module")
def problem():
    mesh = synthetic_voronoi_mesh(ncells=3000, nz=3, nsoil=1, seed=9)
    grid = coarse_lambert_grid(nx=64, ny=40, dx=80e3)
    ro = reorder_cells_morton(mesh, grid.proj)
    ell = bilinear_cell_weights(ro.mesh, grid.lat, grid.lon)
    return ro.mesh, grid, ell


def test_slab_matmul_matches_xla(problem):
    mesh, grid, ell = problem
    rng = np.random.default_rng(4)
    src = rng.standard_normal((mesh.ncells, 5)).astype(np.float32)
    ref = Regridder(ell, dtype=jnp.float32).apply_np(src)
    # default mode is "highest": f32 operands, Precision.HIGHEST (parity-safe)
    mm = SlabMatmulRegridder(ell)
    assert mm.precision == "highest"
    out = mm.apply_np(src)
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-5)
    # 1-D source
    out1 = mm.apply_np(src[:, 0])
    np.testing.assert_allclose(out1, ref[:, :, 0], rtol=2e-6, atol=2e-5)
    # split mode: one bf16 contraction, compensated bf16x3 product
    out_b = SlabMatmulRegridder(ell, precision="split_bf16").apply_np(src)
    np.testing.assert_allclose(out_b, ref, rtol=1e-4, atol=1e-4)


def test_slab_matmul_column_chunking(problem):
    """Widths straddling both the CB sub-chunk and the LANE pad quantum."""
    mesh, grid, ell = problem
    rng = np.random.default_rng(5)
    for C in (CB + 7, LANE, LANE + 1, 2 * CB + LANE):
        src = rng.standard_normal((mesh.ncells, C)).astype(np.float32)
        ref = Regridder(ell, dtype=jnp.float32).apply_np(src)
        out = SlabMatmulRegridder(ell).apply_np(src)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_device_call_matches_apply_np(problem):
    """__call__ (device path) honors the (nyp, nxp, C) contract and matches
    apply_np's cropped result."""
    mesh, grid, ell = problem
    rng = np.random.default_rng(6)
    src = rng.standard_normal((mesh.ncells, 3)).astype(np.float32)
    ny, nx = ell.dst_shape
    mm = SlabMatmulRegridder(ell)
    out_dev = np.asarray(mm(jnp.asarray(src)))
    assert out_dev.shape == (mm.nty * 32, mm.ntx * 32, 3)
    np.testing.assert_allclose(
        out_dev[:ny, :nx], mm.apply_np(src), rtol=1e-6, atol=1e-7)


def test_sharded_fused_output_shape(problem):
    """With a device mesh, the device-padding tile rows are cropped back
    off: the sharded __call__ has the unsharded (nyp, nxp, C) shape and
    values."""
    from mpassit_jax.parallel.sharding import make_grid_mesh

    mesh, grid, ell = problem
    dmesh = make_grid_mesh(jax.devices()[:8])
    rng = np.random.default_rng(8)
    src = rng.standard_normal((mesh.ncells, 2)).astype(np.float32)
    mm = SlabMatmulRegridder(ell, mesh=dmesh)
    assert mm.nty_p % 8 == 0 and mm.nty_p > mm.nty
    out = np.asarray(mm(jnp.asarray(src)))
    out_1 = np.asarray(SlabMatmulRegridder(ell)(jnp.asarray(src)))
    assert out.shape == out_1.shape == (mm.nty * 32, mm.ntx * 32, 2)
    np.testing.assert_array_equal(out, out_1)


def test_fused_sharded_jit_is_reused(problem):
    """Repeated sharded applies of one width reuse their compiled tile
    matmul: the second call traces nothing new on the hot bundle path."""
    from mpassit_jax.ops.matmul_apply import _tile_matmul
    from mpassit_jax.parallel.sharding import make_grid_mesh

    mesh, grid, ell = problem
    dmesh = make_grid_mesh(jax.devices()[:8])
    mm = SlabMatmulRegridder(ell, mesh=dmesh)
    src = jnp.asarray(np.random.default_rng(9).standard_normal(
        (mesh.ncells, 2)).astype(np.float32))
    first = np.asarray(mm(src))
    n_compiled = _tile_matmul._cache_size()
    np.testing.assert_array_equal(np.asarray(mm(src)), first)
    assert _tile_matmul._cache_size() == n_compiled


def test_fused_sharded_reroutes_when_ell_stops_fitting(problem):
    """A narrow first bundle must not pin state that a later, wider bundle
    (another padded width, another CB chunk count) reuses wrongly: both
    calls on one sharded engine equal fresh engines' results."""
    from mpassit_jax.parallel.sharding import make_grid_mesh

    mesh, grid, ell = problem
    dmesh = make_grid_mesh(jax.devices()[:8])
    mm = SlabMatmulRegridder(ell, mesh=dmesh)
    rng = np.random.default_rng(11)
    narrow = jnp.asarray(rng.standard_normal(
        (mesh.ncells, 2)).astype(np.float32))
    wide = jnp.asarray(rng.standard_normal(
        (mesh.ncells, CB + 130)).astype(np.float32))
    out_n = np.asarray(mm(narrow))
    out_w = np.asarray(mm(wide))
    assert out_w.shape[2] == CB + 130
    np.testing.assert_array_equal(
        out_w, np.asarray(SlabMatmulRegridder(ell, mesh=dmesh)(wide)))
    np.testing.assert_array_equal(
        out_n, np.asarray(SlabMatmulRegridder(ell, mesh=dmesh)(narrow)))


def test_precision_error_bounds(problem):
    """Backs the documented error claims (ops/matmul_apply.py docstring,
    CMakeLists.txt:80 reference f64 compute): vs an f64 oracle apply,
    precision="highest" carries ~1e-7 relative error (f32 rounding) and
    precision="split_bf16" ~1e-5 (compensated bf16x3 product)."""
    mesh, grid, ell = problem
    rng = np.random.default_rng(7)
    src64 = rng.standard_normal((mesh.ncells, 8))
    ref = Regridder(ell, dtype=jnp.float64).apply_np(src64)
    src32 = src64.astype(np.float32)
    scale = np.abs(ref) + 1.0  # rng values are O(1); guards unmapped zeros

    err_h = np.abs(SlabMatmulRegridder(ell, precision="highest")
                   .apply_np(src32) - ref) / scale
    err_b = np.abs(SlabMatmulRegridder(ell, precision="split_bf16")
                   .apply_np(src32) - ref) / scale
    err_6 = np.abs(SlabMatmulRegridder(ell, precision="split6_bf16")
                   .apply_np(src32) - ref) / scale
    assert np.quantile(err_h, 0.99) < 5e-7, err_h.max()
    assert err_h.max() < 5e-6
    assert np.quantile(err_b, 0.99) < 5e-5, err_b.max()
    assert err_b.max() < 1e-3
    # split6 stacks the same six compensated terms Precision.HIGHEST
    # computes — it must land in highest's error class, not split_bf16's
    assert np.quantile(err_6, 0.99) < 5e-7, err_6.max()
    assert err_6.max() < 5e-6
    # the speed mode really is coarser — otherwise the bounds prove nothing
    assert err_b.max() > err_h.max()
    assert err_b.max() > err_6.max()


def test_rejects_too_many_uniques(problem):
    """A fully scattered operator exceeds the per-tile unique-row cap."""
    mesh, grid, ell = problem
    rng = np.random.default_rng(1)
    # a fake huge source space so a 32x32 tile's K*TILE random draws
    # exceed W_CAP distinct rows
    scrambled = dataclasses.replace(ell, n_src=500_000, idx=rng.integers(
        0, 500_000, size=ell.idx.shape).astype(np.int32))
    with pytest.raises(ValueError, match="unique source rows"):
        SlabMatmulRegridder(scrambled)


def test_split_hilo_residual_survives_jit():
    """Guards the optimization_barrier in _split_hilo: XLA on the GPU
    folds f32->bf16->f32 round-trips to identity without it, zeroing the
    compensation term and silently degrading split_bf16 to plain bf16."""
    x = jnp.asarray(np.float32(1.0) + np.float32(1e-3) *
                    np.arange(1, 257, dtype=np.float32))
    hi, lo = jax.jit(_split_hilo)(x)
    lo32 = np.asarray(lo, np.float32)
    assert (np.abs(lo32) > 0).any(), "residual folded to zero under jit"
    recon = np.asarray(hi, np.float32) + lo32
    np.testing.assert_allclose(recon, np.asarray(x), rtol=2e-5)
    # hi alone must NOT reconstruct (otherwise the test proves nothing)
    assert np.abs(np.asarray(hi, np.float32) - np.asarray(x)).max() > 1e-4


# --- PackedSlabRegridder: one kernel pass for several methods -------------


@pytest.fixture(scope="module")
def packed_problem(problem):
    from mpassit_jax.weights.conservative import conservative_weights
    from mpassit_jax.weights.nearest import nearest_weights

    mesh, grid, ell_b = problem
    ell_n = nearest_weights(mesh, grid.lat, grid.lon)
    ell_c = conservative_weights(mesh, grid)
    rng = np.random.default_rng(10)
    cols = [5, 3, 2]
    src = rng.standard_normal(
        (mesh.ncells, sum(cols))).astype(np.float32)
    return (ell_b, ell_n, ell_c), cols, src


@pytest.mark.parametrize("precision", ["highest", "split_bf16",
                                       "split6_bf16"])
def test_packed_matches_separate(packed_problem, precision):
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder

    (ell_b, ell_n, ell_c), cols, src = packed_problem
    packed = PackedSlabRegridder(
        list(zip((ell_b, ell_n, ell_c), cols)), precision=precision)
    got = packed.apply_np(src)
    off = 0
    for ell, c in zip((ell_b, ell_n, ell_c), cols):
        want = SlabMatmulRegridder(ell, precision=precision).apply_np(
            src[:, off:off + c])
        np.testing.assert_allclose(got[:, :, off:off + c], want,
                                   rtol=1e-6, atol=1e-7,
                                   err_msg=ell.method)
        off += c


def test_packed_device_call_and_validation(packed_problem):
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder

    (ell_b, ell_n, ell_c), cols, src = packed_problem
    packed = PackedSlabRegridder(list(zip((ell_b, ell_n, ell_c), cols)))
    out = np.asarray(packed(jnp.asarray(src)))
    assert out.shape == (packed.nty * 32, packed.ntx * 32, sum(cols))
    ny, nx = ell_b.dst_shape
    np.testing.assert_allclose(out[:ny, :nx], packed.apply_np(src),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="columns"):
        packed(jnp.asarray(src[:, :4]))


def test_packed_sharded_matches_single(packed_problem):
    from mpassit_jax.parallel.sharding import make_grid_mesh
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder

    (ell_b, ell_n, ell_c), cols, src = packed_problem
    dmesh = make_grid_mesh(jax.devices()[:8])
    single = PackedSlabRegridder(list(zip((ell_b, ell_n, ell_c), cols)))
    sharded = PackedSlabRegridder(list(zip((ell_b, ell_n, ell_c), cols)),
                                  mesh=dmesh)
    np.testing.assert_allclose(sharded.apply_np(src), single.apply_np(src),
                               rtol=1e-6, atol=1e-7)


# --- in-apply Q4 wind rotation (rotate_spec) -------------------------------


def _rotation_fixture(ell_b, seed=3):
    ny, nx = ell_b.dst_shape
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(-0.3, 0.3, size=(ny, nx)).astype(np.float32)
    return np.cos(alpha), np.sin(alpha)


def _rotate_posthoc(out, windows, cosa, sina):
    """The post-hoc reference: the canonical ops.rotate.rotate_winds applied
    to the un-rotated packed output on the host."""
    from mpassit_jax.ops.rotate import rotate_winds

    out = np.array(out)
    for (cu, cv, n) in windows:
        u, v = rotate_winds(jnp.asarray(out[:, :, cu:cu + n]),
                            jnp.asarray(out[:, :, cv:cv + n]),
                            jnp.asarray(cosa), jnp.asarray(sina))
        out[:, :, cu:cu + n] = np.asarray(u)
        out[:, :, cv:cv + n] = np.asarray(v)
    return out


def test_packed_in_apply_rotation_matches_posthoc(packed_problem):
    """rotate_spec pins the in-apply rotation (post-unblock) to the
    canonical post-hoc rotate_winds: window columns rotated per quirk Q4,
    all other columns untouched."""
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder

    (ell_b, ell_n, ell_c), cols, src = packed_problem
    cosa, sina = _rotation_fixture(ell_b)
    windows = ((0, 2, 2),)   # u = cols [0,2), v = cols [2,4) of bilinear's 5
    spec = list(zip((ell_b, ell_n, ell_c), cols))
    plain = PackedSlabRegridder(spec)
    rot = PackedSlabRegridder(spec, rotate_spec=(windows, cosa, sina))
    base = plain.apply_np(src)
    got = rot.apply_np(src)
    want = _rotate_posthoc(base, windows, cosa, sina)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # columns outside the windows are bit-identical to the plain apply
    np.testing.assert_array_equal(got[:, :, 4:], base[:, :, 4:])
    # device __call__ agrees with apply_np under rotation too
    ny, nx = ell_b.dst_shape
    out_dev = np.asarray(rot(jnp.asarray(src)))
    np.testing.assert_allclose(out_dev[:ny, :nx], got, rtol=1e-6, atol=1e-6)


def test_packed_rotation_sharded_matches_single(packed_problem):
    """Row-sharded cosa/sina follow their output shard; identity padding
    (cosa=1, sina=0) keeps padded rows NaN-free on every device."""
    from mpassit_jax.parallel.sharding import make_grid_mesh
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder

    (ell_b, ell_n, ell_c), cols, src = packed_problem
    cosa, sina = _rotation_fixture(ell_b, seed=4)
    windows = ((0, 2, 2),)
    spec = list(zip((ell_b, ell_n, ell_c), cols))
    dmesh = make_grid_mesh(jax.devices()[:8])
    single = PackedSlabRegridder(spec, rotate_spec=(windows, cosa, sina))
    sharded = PackedSlabRegridder(spec, mesh=dmesh,
                                  rotate_spec=(windows, cosa, sina))
    got_s = sharded.apply_np(src)
    assert np.isfinite(got_s).all()
    np.testing.assert_allclose(got_s, single.apply_np(src),
                               rtol=1e-6, atol=1e-7)


def test_rotate_window_validation(packed_problem):
    """Windows must hold u before v without overlap inside the packed
    columns; any such window is rotated, also one that spans CB
    sub-chunks."""
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder

    (ell_b, ell_n, ell_c), cols, src = packed_problem
    cosa, sina = _rotation_fixture(ell_b)
    spec = list(zip((ell_b, ell_n, ell_c), cols))
    for bad in ((0, 8, 4),      # v past the 10 packed columns
                (0, 1, 2),      # v overlapping u (cv < cu+n)
                (3, 0, 2)):     # v before u
        with pytest.raises(ValueError, match="rotate window"):
            PackedSlabRegridder(spec, rotate_spec=((bad,), cosa, sina))
    wide_cols = [2 * CB + 8, 3, 2]
    wide_src = np.random.default_rng(12).standard_normal(
        (ell_b.n_src, sum(wide_cols))).astype(np.float32)
    wide_spec = list(zip((ell_b, ell_n, ell_c), wide_cols))
    windows = ((0, CB + 4, 4),)     # v in the second CB sub-chunk
    got = PackedSlabRegridder(
        wide_spec, rotate_spec=(windows, cosa, sina)).apply_np(wide_src)
    base = PackedSlabRegridder(wide_spec).apply_np(wide_src)
    np.testing.assert_allclose(
        got, _rotate_posthoc(base, windows, cosa, sina), rtol=1e-6,
        atol=1e-6)


# --- device-memory-bounded grouped apply (production envelope) -------------


@pytest.mark.parametrize("rotate", [False, True])
def test_packed_grouped_apply_matches_full(packed_problem, monkeypatch,
                                           rotate):
    """The device-memory-bounded path: when the one-pass device working
    set exceeds the device budget (MPASSIT_DEVICE_BUDGET_GB where the
    backend reports no memory limit, as the CPU), apply_np runs in column
    groups with windowed source uploads. Grouped must equal full-width
    bit-for-bit, rotation included."""
    from mpassit_jax.ops.matmul_apply import FETCH, PackedSlabRegridder

    (ell_b, ell_n, ell_c), _, _ = packed_problem
    cols = [500, 80, 60]                     # Cp = 640 > FETCH
    rng = np.random.default_rng(21)
    src = rng.standard_normal(
        (ell_b.n_src, sum(cols))).astype(np.float32)
    spec = list(zip((ell_b, ell_n, ell_c), cols))
    kw = {}
    if rotate:
        cosa, sina = _rotation_fixture(ell_b)
        kw["rotate_spec"] = (((0, 2, 2),), cosa, sina)
    pk = PackedSlabRegridder(spec, **kw)
    assert pk.Cp > FETCH
    full = pk.apply_np(src)
    assert pk._grouped_width() == 0          # default budget: one pass
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", "0.001")
    gw = pk._grouped_width()
    assert gw and gw < pk.Cp
    grouped = pk.apply_np(src)
    np.testing.assert_array_equal(grouped, full)
    # block-list sources and strip streaming take the same grouped path
    blocks = [src[:, :17], src[:, 17:300], src[:, 300:]]
    strips = {}
    pk.apply_np(blocks, strip_sink=lambda lo, s: strips.__setitem__(
        lo, np.array(s)))
    got = np.concatenate([strips[k] for k in sorted(strips)], axis=2)
    np.testing.assert_array_equal(got, full)
