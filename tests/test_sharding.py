"""Distributed correctness: sharded result == unsharded result (SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpassit_jax.ops.apply import Regridder
from mpassit_jax.parallel.sharding import (
    ShardedRegridder,
    make_grid_mesh,
    shard_map_apply,
)
from mpassit_jax.weights.bilinear import bilinear_cell_weights

from test_weights import coarse_lambert_grid


@pytest.fixture(scope="module")
def ell(small_mesh):
    grid = coarse_lambert_grid(nx=23, ny=17)   # deliberately not div by 8
    return bilinear_cell_weights(small_mesh, grid.lat, grid.lon)


def test_mesh_has_8_devices():
    mesh = make_grid_mesh()
    assert mesh.devices.size == 8


def test_sharded_equals_unsharded(small_mesh, ell):
    mesh = make_grid_mesh()
    rng = np.random.default_rng(5)
    src = rng.standard_normal((small_mesh.ncells, 9))

    ref = Regridder(ell, dtype=jnp.float64).apply_np(src)
    out = ShardedRegridder(ell, mesh, dtype=jnp.float64).apply_np(src)
    # f64 on CPU: bit-identical contraction order per row
    np.testing.assert_array_equal(out.reshape(ref.shape), ref)


def test_shard_map_apply_matches(small_mesh, ell):
    mesh = make_grid_mesh()
    rng = np.random.default_rng(6)
    src = rng.standard_normal((small_mesh.ncells, 4))
    ref = Regridder(ell, dtype=jnp.float64).apply_np(src).reshape(-1, 4)
    out = np.asarray(shard_map_apply(ell, mesh, src, dtype=jnp.float64))
    np.testing.assert_allclose(out, ref, rtol=1e-13)

    # 1-D source path
    ref1 = Regridder(ell, dtype=jnp.float64).apply_np(src[:, 0]).reshape(-1)
    out1 = np.asarray(shard_map_apply(ell, mesh, src[:, 0], dtype=jnp.float64))
    np.testing.assert_allclose(out1, ref1, rtol=1e-13)


def test_slab_matmul_sharded_equals_unsharded(small_mesh, ell):
    """Tile-sharded SlabMatmulRegridder == single-device result (f32)."""
    from mpassit_jax.ops.matmul_apply import SlabMatmulRegridder

    mesh = make_grid_mesh()
    rng = np.random.default_rng(7)
    src = rng.standard_normal((small_mesh.ncells, 6)).astype(np.float32)

    ref = SlabMatmulRegridder(ell).apply_np(src)
    out = SlabMatmulRegridder(ell, mesh=mesh).apply_np(src)
    np.testing.assert_array_equal(out, ref)


def test_pipeline_with_device_shards(tmp_path):
    """n_device_shards=8 drives the full pipeline on the virtual CPU mesh."""
    import jax.numpy as jnp

    from mpassit_jax.run.pipeline import run_pipeline
    from test_pipeline import make_case

    mesh, cfg, hist_fields, diag_fields = make_case(tmp_path, ncells=900,
                                                    nx=17, ny=13)
    art_ref = run_pipeline(cfg, dtype=jnp.float32)
    ref_t2 = [x for x in art_ref.result.diag2d if x[0] == "T2"][0][1]

    cfg.n_device_shards = -1
    cfg.output_file = str(tmp_path / "out_sharded.nc")
    art = run_pipeline(cfg, dtype=jnp.float32)
    t2 = [x for x in art.result.diag2d if x[0] == "T2"][0][1]
    np.testing.assert_allclose(t2, ref_t2, rtol=1e-6)


@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_source_sharded_regridder_matches(small_mesh, ell, comm):
    """The production source-sharded engine (both source and target rows
    sharded, halo over the mesh) == unsharded apply."""
    from mpassit_jax.parallel.sharding import SourceShardedRegridder

    mesh = make_grid_mesh()
    rng = np.random.default_rng(9)
    src = rng.standard_normal((small_mesh.ncells, 5))
    ref = Regridder(ell, dtype=jnp.float64).apply_np(src)
    rg = SourceShardedRegridder(ell, mesh, dtype=jnp.float64, comm=comm)
    out = rg.apply_np(src)
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13)
    out1 = rg.apply_np(src[:, 0])
    np.testing.assert_allclose(out1, ref[..., 0], rtol=1e-13, atol=1e-13)


def test_pipeline_source_decomp_ring(tmp_path):
    """Full pipeline with the source-sharded ring path selected from the
    namelist (source_decomp='ring', n_device_shards=-1) == replicated run."""
    import jax.numpy as jnp

    from mpassit_jax.parallel.sharding import SourceShardedRegridder
    from mpassit_jax.run.pipeline import run_pipeline
    from test_pipeline import make_case

    mesh, cfg, hist_fields, diag_fields = make_case(tmp_path, ncells=900,
                                                    nx=17, ny=13)
    art_ref = run_pipeline(cfg, dtype=jnp.float64)

    cfg.n_device_shards = -1
    cfg.source_decomp = "ring"
    cfg.output_file = str(tmp_path / "out_ring.nc")
    art = run_pipeline(cfg, dtype=jnp.float64)
    assert all(isinstance(r, SourceShardedRegridder)
               for r in art.regridders.values())
    for (na, a, *_), (nb, b, *_) in zip(
            art.result.diag2d + art.result.nz3d,
            art_ref.result.diag2d + art_ref.result.nz3d):
        assert na == nb
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                   err_msg=na)
    np.testing.assert_allclose(art.result.u, art_ref.result.u,
                               rtol=1e-12, atol=1e-12)


def test_ring_apply_matches(small_mesh, ell):
    """Ring ppermute halo apply == unsharded apply (f64 bit-parity per row
    requires same contraction order; the ring accumulates per-block partials,
    so compare allclose)."""
    from mpassit_jax.parallel.sharding import ring_apply

    mesh = make_grid_mesh()
    rng = np.random.default_rng(8)
    src = rng.standard_normal((small_mesh.ncells, 5))
    ref = Regridder(ell, dtype=jnp.float64).apply_np(src).reshape(-1, 5)
    out = np.asarray(ring_apply(ell, mesh, src, dtype=jnp.float64))
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13)

    # 1-D path
    ref1 = ref[:, 0]
    out1 = np.asarray(ring_apply(ell, mesh, src[:, 0], dtype=jnp.float64))
    np.testing.assert_allclose(out1, ref1, rtol=1e-13, atol=1e-13)
