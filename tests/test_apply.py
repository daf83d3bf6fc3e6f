import jax
import jax.numpy as jnp
import numpy as np

from mpassit_jax.ops.apply import Regridder, apply_ell
from mpassit_jax.ops.rotate import rotate_winds
from mpassit_jax.weights.bilinear import bilinear_cell_weights
from mpassit_jax.weights.cache import WeightCache, grid_fingerprint
from mpassit_jax.weights.ell import ELLWeights
from mpassit_jax.weights.nearest import nearest_weights

from test_weights import coarse_lambert_grid


def test_apply_matches_numpy_oracle(small_mesh):
    grid = coarse_lambert_grid(nx=16, ny=12)
    ell = bilinear_cell_weights(small_mesh, grid.lat, grid.lon)
    rng = np.random.default_rng(0)
    src = rng.standard_normal((small_mesh.ncells, 7))

    oracle = (ell.w[:, :, None] * src[ell.idx]).sum(axis=1)
    rg = Regridder(ell, dtype=jnp.float64)
    out = rg.apply_np(src)
    np.testing.assert_allclose(out.reshape(-1, 7), oracle, rtol=1e-12)

    # 1-D source
    out1 = rg.apply_np(src[:, 0])
    np.testing.assert_allclose(out1.reshape(-1), oracle[:, 0], rtol=1e-12)


def test_apply_f32_close_to_f64(small_mesh):
    grid = coarse_lambert_grid(nx=16, ny=12)
    ell = bilinear_cell_weights(small_mesh, grid.lat, grid.lon)
    rng = np.random.default_rng(1)
    src = rng.standard_normal((small_mesh.ncells, 3)) * 100.0
    o64 = Regridder(ell, dtype=jnp.float64).apply_np(src)
    o32 = Regridder(ell, dtype=jnp.float32).apply_np(src.astype(np.float32))
    np.testing.assert_allclose(o32, o64, rtol=2e-5, atol=1e-4)


def test_apply_column_chunking(small_mesh):
    grid = coarse_lambert_grid(nx=8, ny=6)
    ell = nearest_weights(small_mesh, grid.lat, grid.lon)
    src = np.arange(small_mesh.ncells * 70, dtype=np.float64).reshape(
        small_mesh.ncells, 70)
    rg_small = Regridder(ell, dtype=jnp.float64, max_cols=16)
    rg_big = Regridder(ell, dtype=jnp.float64, max_cols=1024)
    np.testing.assert_array_equal(rg_small.apply_np(src), rg_big.apply_np(src))


def test_unmapped_rows_stay_zero():
    """Quirk Q5: unmapped targets keep the zero-initialized destination."""
    idx = np.array([[1, 2, 3], [0, 0, 0]], dtype=np.int32)
    w = np.array([[0.2, 0.3, 0.5], [0.0, 0.0, 0.0]])
    ell = ELLWeights(idx=idx, w=w, n_src=5, method="bilinear", dst_shape=(2,))
    src = np.arange(5.0)
    out = Regridder(ell, dtype=jnp.float64).apply_np(src)
    assert out[1] == 0.0
    np.testing.assert_allclose(out[0], 0.2 * 1 + 0.3 * 2 + 0.5 * 3)


def test_rotate_winds_q4_sequential():
    """v must be computed from the already-rotated u (quirk Q4)."""
    rng = np.random.default_rng(2)
    ny, nx, nz = 4, 5, 3
    u = rng.standard_normal((ny, nx, nz))
    v = rng.standard_normal((ny, nx, nz))
    cosa = np.cos(rng.uniform(-0.2, 0.2, (ny, nx)))
    sina = np.sin(rng.uniform(-0.2, 0.2, (ny, nx)))
    ur, vr = rotate_winds(jnp.asarray(u), jnp.asarray(v),
                          jnp.asarray(cosa), jnp.asarray(sina))
    # scalar reference implementing interp.F90:737-748 literally
    for j in range(ny):
        for i in range(nx):
            tana = sina[j, i] / cosa[j, i]
            uu = (u[j, i] + v[j, i] * tana) / (cosa[j, i] + sina[j, i] * tana)
            vv = (v[j, i] - uu * sina[j, i]) / cosa[j, i]
            np.testing.assert_allclose(ur[j, i], uu, rtol=1e-12)
            np.testing.assert_allclose(vr[j, i], vv, rtol=1e-12)
    # and 2-D variant
    ur2, vr2 = rotate_winds(jnp.asarray(u[:, :, 0]), jnp.asarray(v[:, :, 0]),
                            jnp.asarray(cosa), jnp.asarray(sina))
    np.testing.assert_allclose(ur2, ur[:, :, 0], rtol=1e-12)


def test_weight_cache_roundtrip(tmp_path, small_mesh):
    grid = coarse_lambert_grid(nx=8, ny=6)
    cache = WeightCache(str(tmp_path))
    calls = []

    def builder():
        calls.append(1)
        return nearest_weights(small_mesh, grid.lat, grid.lon)

    fp_m, fp_g = small_mesh.fingerprint(), grid_fingerprint(grid)
    e1 = cache.get_or_build("nearest", fp_m, fp_g, builder)
    e2 = cache.get_or_build("nearest", fp_m, fp_g, builder)
    assert len(calls) == 1  # second call hit the cache
    assert np.array_equal(e1.idx, e2.idx)
