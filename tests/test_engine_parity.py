"""Every apply engine that stays, for every method and apply_precision,
against a float64 NumPy apply of the same weights (sum_k w * src[idx]) —
the bounds chip_smoke.py holds the pipeline to on the GPU:
max|out - ref| / max|ref| <= 2e-6 (5e-5 for split_bf16)."""

import numpy as np
import pytest

import jax.numpy as jnp

from mpassit_jax.mesh.reorder import reorder_cells_morton
from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_jax.ops.apply import Regridder
from mpassit_jax.ops.matmul_apply import (
    PRECISIONS,
    PackedSlabRegridder,
    SlabMatmulRegridder,
)
from mpassit_jax.weights.bilinear import bilinear_cell_weights
from mpassit_jax.weights.conservative import conservative_weights
from mpassit_jax.weights.nearest import nearest_weights

from test_weights import coarse_lambert_grid

TOL = {"highest": 2e-6, "split6_bf16": 2e-6, "split_bf16": 5e-5}
METHODS = ("bilinear", "nearest", "conserve")


@pytest.fixture(scope="module")
def case():
    mesh = synthetic_voronoi_mesh(ncells=2500, nz=3, nsoil=1, seed=13)
    grid = coarse_lambert_grid(nx=50, ny=37, dx=90e3)
    mesh = reorder_cells_morton(mesh, grid.proj).mesh
    ells = {"bilinear": bilinear_cell_weights(mesh, grid.lat, grid.lon),
            "nearest": nearest_weights(mesh, grid.lat, grid.lon),
            "conserve": conservative_weights(mesh, grid)}
    rng = np.random.default_rng(17)
    # offset fields, like the model's (theta ~ 300 K): the relative bound
    # is then dominated by the products, not by cancellation
    src = 10.0 + rng.standard_normal((mesh.ncells, 6))
    alpha = rng.uniform(-0.4, 0.4, size=grid.shape)
    return grid, ells, src, np.cos(alpha), np.sin(alpha)


def ref_apply(ell, src):
    out = np.einsum("tk,tkc->tc", np.asarray(ell.w, np.float64),
                    src[np.asarray(ell.idx)])
    return out.reshape(tuple(ell.dst_shape) + (src.shape[1],))


def ref_rotate(u, v, cosa, sina):
    cosa, sina = cosa[:, :, None], sina[:, :, None]
    tana = sina / cosa
    un = (u + v * tana) / (cosa + sina * tana)
    return un, (v - un * sina) / cosa


def rel_err(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("method", METHODS)
def test_gather_regridder_matches_f64(case, method):
    grid, ells, src, *_ = case
    got = Regridder(ells[method], dtype=jnp.float32).apply_np(
        src.astype(np.float32))
    assert rel_err(got, ref_apply(ells[method], src)) <= 2e-6


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", METHODS)
def test_slab_matmul_matches_f64(case, method, precision):
    grid, ells, src, *_ = case
    got = SlabMatmulRegridder(ells[method], precision=precision).apply_np(
        src.astype(np.float32))
    assert rel_err(got, ref_apply(ells[method], src)) <= TOL[precision]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("rotate", [False, True], ids=["plain", "rotated"])
def test_packed_matches_f64(case, method, precision, rotate):
    """The tested method leads the packed operator (4 columns: u, v in
    the rotated case), the other two follow with one column each."""
    grid, ells, src, cosa, sina = case
    order = [method] + [m for m in METHODS if m != method]
    cols = [4, 1, 1]
    spec = [(ells[m], c) for m, c in zip(order, cols)]
    windows = ((0, 2, 2),)
    pk = PackedSlabRegridder(
        spec, precision=precision,
        rotate_spec=(windows, cosa, sina) if rotate else None)
    got = pk.apply_np(src.astype(np.float32))
    ref = np.concatenate(
        [ref_apply(ells[m], src[:, o:o + c])
         for m, c, o in zip(order, cols, (0, 4, 5))], axis=2)
    if rotate:
        u, v = ref_rotate(ref[:, :, 0:2], ref[:, :, 2:4], cosa, sina)
        ref = np.concatenate([u, v, ref[:, :, 4:]], axis=2)
    for c in range(sum(cols)):
        assert rel_err(got[:, :, c], ref[:, :, c]) <= TOL[precision], c
