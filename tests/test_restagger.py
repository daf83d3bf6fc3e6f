"""Center -> edge-stagger spherical bilinear operator (VERDICT item 3).

The reference restaggers U/V with a second ESMF grid->grid bilinear regrid
(interp.F90:295-328). These tests pin the ELL operator's structure (row
sums, unmapped boundary, K=4), its accuracy against the analytic field at
the staggered coordinates, and quantify its deviation from the round-1
index-space midpoint approximation.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mpassit_jax.ops.apply import Regridder
from mpassit_jax.weights.restagger import edge1_weights, edge2_weights

from test_weights import coarse_lambert_grid


@pytest.fixture(scope="module")
def grid():
    return coarse_lambert_grid(nx=40, ny=30, dx=120e3)


def test_edge_weight_structure(grid):
    for ell, shape, outer in (
        (edge1_weights(grid), (grid.ny, grid.nx + 1), "cols"),
        (edge2_weights(grid), (grid.ny + 1, grid.nx), "rows"),
    ):
        assert ell.dst_shape == shape
        assert ell.idx.shape[1] == 4
        rs = ell.w.reshape(shape + (4,)).sum(axis=-1)
        if outer == "cols":
            # quirk Q6: outermost staggered columns unmapped -> zero rows
            assert (rs[:, 0] == 0).all() and (rs[:, -1] == 0).all()
            np.testing.assert_allclose(rs[:, 1:-1], 1.0, atol=1e-12)
        else:
            assert (rs[0, :] == 0).all() and (rs[-1, :] == 0).all()
            np.testing.assert_allclose(rs[1:-1, :], 1.0, atol=1e-12)
        assert (ell.w >= -1e-15).all()


def test_edge1_accuracy_vs_analytic(grid):
    """Restaggering a smooth analytic field must reproduce the field at the
    EDGE1 coordinates to O(h^2)."""
    f = np.sin(np.deg2rad(grid.lat)) * np.cos(np.deg2rad(grid.lon))
    ell = edge1_weights(grid)
    out = Regridder(ell, dtype=jnp.float64).apply_np(f.reshape(-1))
    want = np.sin(np.deg2rad(grid.lat_u)) * np.cos(np.deg2rad(grid.lon_u))
    h2 = (120e3 / 6370e3) ** 2
    np.testing.assert_allclose(out[:, 1:-1], want[:, 1:-1], atol=h2)


def test_edge2_accuracy_vs_analytic(grid):
    f = np.sin(np.deg2rad(grid.lat)) * np.cos(np.deg2rad(grid.lon))
    ell = edge2_weights(grid)
    out = Regridder(ell, dtype=jnp.float64).apply_np(f.reshape(-1))
    want = np.sin(np.deg2rad(grid.lat_v)) * np.cos(np.deg2rad(grid.lon_v))
    h2 = (120e3 / 6370e3) ** 2
    np.testing.assert_allclose(out[1:-1, :], want[1:-1, :], atol=h2)


def test_deviation_from_midpoint_quantified(grid):
    """The round-1 midpoint restagger differs from the spherical bilinear
    by O(h^2) relative — measurable but small. This pins the bound the
    VERDICT asked for (weak #2): the two must AGREE to ~h^2 and genuinely
    DIFFER (the operator is not secretly 0.5/0.5)."""
    from mpassit_jax.run.pipeline import restagger_u_midpoint

    rng = np.random.default_rng(0)
    f = (np.sin(np.deg2rad(grid.lat) * 3) * np.cos(np.deg2rad(grid.lon) * 2)
         + 0.1 * rng.standard_normal(grid.lat.shape))
    mid = restagger_u_midpoint(f[..., None])[..., 0]
    ell = edge1_weights(grid)
    out = Regridder(ell, dtype=jnp.float64).apply_np(f.reshape(-1))
    diff = np.abs(out[:, 1:-1] - mid[:, 1:-1]).max()
    h2 = (120e3 / 6370e3) ** 2                    # (dx/R)^2 ~ 3.5e-4
    assert diff < 5 * h2, diff
    assert diff > 1e-3 * h2, "operator collapsed to exact midpoints"


def test_interior_weights_near_half(grid):
    """Interior EDGE1 weights concentrate on the two adjacent mass columns
    at ~0.5 each; cross-row leakage is O(h^2)."""
    ell = edge1_weights(grid)
    W = ell.w.reshape(grid.ny, grid.nx + 1, 4)
    j, i = grid.ny // 2, grid.nx // 2
    w = np.sort(W[j, i])[::-1]
    assert abs(w[0] - 0.5) < 0.01 and abs(w[1] - 0.5) < 0.01
    assert w[2] + w[3] < 0.01


def test_pipeline_winds_use_operator(tmp_path):
    """End-to-end: U/V come out of the ELL restagger path (regridders dict
    carries edge1/edge2) and interior values still track the source wind."""
    from mpassit_jax.run.pipeline import run_pipeline
    from test_pipeline import make_case

    mesh, cfg, hist_fields, _ = make_case(tmp_path, nx=17, ny=13)
    art = run_pipeline(cfg, dtype=jnp.float64)
    assert "edge1" in art.regridders and "edge2" in art.regridders
    u = art.result.u
    assert u.shape == (13, 18, mesh.nz)
    assert (u[:, 0] == 0).all() and (u[:, -1] == 0).all()
    assert abs(u[:, 1:-1, 0].mean() - 15.0) < 1.5
