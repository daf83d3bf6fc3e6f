"""ESMF-convention stress fixtures (VERDICT r2 item 5 / DESIGN.md
"Parity-risk register"): geometries where our asserted equivalence with
ESMF's numerics is most at risk — obtuse/sliver dual triangles, partially
covered conservative boundary cells, pentagon source cells, and the
restagger boundary SLACK clip. Each register row cites one of these tests.
"""

import numpy as np
import pytest

from mpassit_jax.grids.target import TargetGrid
from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh
from mpassit_jax.weights.bilinear import bilinear_cell_weights
from mpassit_jax.weights.conservative import conservative_weights
from mpassit_jax.weights.restagger import SLACK, edge1_weights

from oracle import (
    assert_weight_dicts_close,
    ell_to_dicts,
    oracle_bilinear_cell,
    oracle_conservative,
)
from test_weight_oracle import _grid_from_plane, _plane_to_latlon, hex_patch_mesh


# --- R1: obtuse / sliver dual triangles ---------------------------------


def _squashed_mesh(factor):
    """Hex patch with cell centers squashed in y: every dual triangle
    becomes a sliver (min angle -> 0 as factor grows). Bilinear weights use
    only cells_on_vertex + centers, so the distorted centers are a valid
    element-located-bilinear stress case even though the vertices are no
    longer circumcenters."""
    import dataclasses

    mesh, centers, vxy = hex_patch_mesh(d=0.02, rings=2)
    sq = centers.copy()
    sq[:, 1] /= factor
    lat, lon = _plane_to_latlon(sq[:, 0], sq[:, 1])
    return dataclasses.replace(mesh, lat_cell=lat, lon_cell=lon), sq


@pytest.mark.parametrize("factor", [8.0, 64.0])
def test_bilinear_sliver_triangles_match_oracle(factor):
    """Sliver dual triangles (aspect ratio up to 64): the production
    locate/weights must agree with the independent oracle to 1e-9 and stay
    a partition of unity — near-degenerate barycentric solves are where a
    different formulation (ESMF's or ours) would first diverge."""
    mesh, sq = _squashed_mesh(factor)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.017, 0.017, size=(60, 2))
    pts[:, 1] /= factor
    lat, lon = _plane_to_latlon(pts[:, 0], pts[:, 1])
    ell = bilinear_cell_weights(mesh, lat, lon)
    got = ell_to_dicts(ell)
    want = oracle_bilinear_cell(mesh, lat, lon)
    assert_weight_dicts_close(got, want, tol=1e-9)
    for row in got:
        if row:                                   # mapped
            assert abs(sum(row.values()) - 1.0) < 1e-9
            assert all(-1e-12 <= v <= 1.0 + 1e-12 for v in row.values())


def test_bilinear_obtuse_triangle_interior_point():
    """A target inside a very obtuse dual triangle (near-collinear cell
    centers) still maps with finite, normalized weights."""
    mesh, sq = _squashed_mesh(64.0)
    # centroid of the most-squashed complete triangle
    tri = mesh.complete_triangles()[0]
    cx = sq[tri, 0].mean()
    cy = sq[tri, 1].mean()
    lat, lon = _plane_to_latlon(np.array([cx]), np.array([cy]))
    d = ell_to_dicts(bilinear_cell_weights(mesh, lat, lon))[0]
    assert d, "centroid of a complete sliver triangle must map"
    assert np.isfinite(list(d.values())).all()
    assert abs(sum(d.values()) - 1.0) < 1e-9


# --- R4: partially covered conservative boundary cells -------------------


def test_conservative_partial_coverage_fracarea():
    """Target cells straddling the source-mesh edge: weights are fractions
    of the TOTAL target area (ESMF fracarea + unmappedaction=IGNORE — no
    renormalization, quirk Q5 analog). Row sums must equal the truly
    covered fraction, pinned against the independent oracle; a constant
    source field comes back scaled by exactly that fraction."""
    mesh, centers, _ = hex_patch_mesh(d=0.02, rings=2)
    # the patch hull reaches |x| ~ 0.05; this grid extends well past it
    g = _grid_from_plane(0.05, 0.0, 0.03, 4)
    ell = conservative_weights(mesh, g)
    got = ell_to_dicts(ell)
    want = oracle_conservative(mesh, g)
    assert_weight_dicts_close(got, want, tol=1e-10)
    sums = np.array([sum(r.values()) for r in got])
    assert (sums > 1.0 - 1e-9).any(), "some cells fully covered"
    assert ((sums > 1e-6) & (sums < 1.0 - 1e-6)).any(), \
        "no partially covered boundary cell exercised"
    assert (sums < 1e-12).any(), "some cells fully outside"
    assert (sums < 1.0 + 1e-9).all()
    # constant field -> exactly the covered fraction, NOT renormalized
    const = np.full(mesh.ncells, 7.0)
    out = (ell.w * const[ell.idx]).sum(axis=1)
    np.testing.assert_allclose(out, 7.0 * sums, rtol=0, atol=1e-9)


# --- R6: pentagon (and irregular-degree) source cells --------------------


def test_conservative_pentagon_cells_match_oracle():
    """Irregular synthetic Voronoi meshes carry pentagons/heptagons; the
    clip pipeline must agree with the list-based oracle on a grid centered
    over a pentagon cell (variable vertex counts exercise the -1-padded
    polygon handling in both the native and NumPy paths)."""
    mesh = synthetic_voronoi_mesh(ncells=300, nz=2, nsoil=1, seed=11)
    nverts = (mesh.vertices_on_cell >= 0).sum(axis=1)
    pentas = np.where(nverts == 5)[0]
    assert len(pentas), "fixture mesh has no pentagon cells"
    c = int(pentas[0])

    # small grid on the gnomonic plane tangent at the pentagon center
    from mpassit_jax.mesh.mpas import lonlat_to_xyz

    n = lonlat_to_xyz(mesh.lon_cell[c], mesh.lat_cell[c])
    ref = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else \
        np.array([1.0, 0.0, 0.0])
    e1 = np.cross(ref, n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    half, m = 0.2, 3        # ~radius of a 300-cell mesh cell
    xs = np.linspace(-half, half, m + 1)
    cxs = 0.5 * (xs[:-1] + xs[1:])

    def to_latlon(x, y):
        p = n[None, None] + x[..., None] * e1 + y[..., None] * e2
        p /= np.linalg.norm(p, axis=-1, keepdims=True)
        return (np.degrees(np.arcsin(p[..., 2])),
                np.degrees(np.arctan2(p[..., 1], p[..., 0])))

    gx, gy = np.meshgrid(cxs, cxs)
    cox, coy = np.meshgrid(xs, xs)
    g = TargetGrid(nx=m, ny=m, proj_code=0)
    g.lat, g.lon = to_latlon(gx, gy)
    g.lat_corner, g.lon_corner = to_latlon(cox, coy)

    ell = conservative_weights(mesh, g)
    got = ell_to_dicts(ell)
    assert any(c in row for row in got), "pentagon cell not in any row"
    assert_weight_dicts_close(got, oracle_conservative(mesh, g), tol=1e-9)


def test_bilinear_native_equals_numpy_on_irregular():
    """The native bary_locate and the NumPy fallback pick identical
    triangles and weights on an irregular mesh (guards the register's
    'same semantics in both paths' claim)."""
    import os
    import subprocess
    import sys

    # run the fallback in a subprocess (native lib loads once per process)
    code = (
        "import os, numpy as np\n"
        "from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh\n"
        "from mpassit_jax.weights.bilinear import bilinear_cell_weights\n"
        "mesh = synthetic_voronoi_mesh(ncells=300, nz=2, nsoil=1, seed=11)\n"
        "rng = np.random.default_rng(5)\n"
        "lat = rng.uniform(-60, 60, 200); lon = rng.uniform(-170, 170, 200)\n"
        "ell = bilinear_cell_weights(mesh, lat, lon)\n"
        "np.savez(os.environ['OUT'], idx=ell.idx, w=ell.w)\n"
    )
    import tempfile

    mesh = synthetic_voronoi_mesh(ncells=300, nz=2, nsoil=1, seed=11)
    rng = np.random.default_rng(5)
    lat = rng.uniform(-60, 60, 200)
    lon = rng.uniform(-170, 170, 200)
    ell = bilinear_cell_weights(mesh, lat, lon)   # native (if available)

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "fb.npz")
        env = dict(os.environ, MPASSIT_NO_NATIVE="1", OUT=out,
                   JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
            + env.get("PYTHONPATH", "").split(os.pathsep))
        subprocess.run([sys.executable, "-c", code], env=env, check=True)
        z = np.load(out)
        got = ell_to_dicts(ell)
        want_ell = type(ell)(idx=z["idx"], w=z["w"], n_src=ell.n_src,
                             method=ell.method, dst_shape=ell.dst_shape,
                             src_loc=ell.src_loc)
        assert_weight_dicts_close(got, ell_to_dicts(want_ell), tol=1e-12)


# --- R3: restagger boundary SLACK clip ------------------------------------


def test_restagger_slack_bound_on_boundary_row():
    """weights/restagger.py clips edge points that fall up to SLACK (1e-2
    of a cell) OUTSIDE their boundary quad onto it instead of unmapping.
    Pin the measurable consequence: on a smooth linear-in-x field, the
    boundary-row restaggered values err by at most ~SLACK of one cell's
    field increment relative to the exact spherical bilinear value, and the
    clipped rows remain a partition of unity."""
    from test_weights import coarse_lambert_grid

    grid = coarse_lambert_grid(nx=24, ny=18, dx=120e3)
    ell = edge1_weights(grid)
    ny, nxp = grid.ny, grid.nx + 1
    w = ell.w.reshape(ny, nxp, -1)
    rowsum = w.sum(axis=2)
    # outermost staggered columns: unmapped (quirk Q6)
    assert (rowsum[:, 0] == 0).all() and (rowsum[:, -1] == 0).all()
    # interior + boundary-row mapped points: exact partition of unity
    mapped = rowsum > 0
    np.testing.assert_allclose(rowsum[mapped], 1.0, atol=1e-9)
    # boundary rows (j=0, j=ny-1) ARE mapped thanks to the SLACK clip
    assert mapped[0, 1:-1].all() and mapped[-1, 1:-1].all()

    # linear-in-index field: restaggered boundary values vs exact midpoint
    # of the two adjacent mass values — the clip may move the evaluation
    # point by at most SLACK of a cell, i.e. SLACK * (unit increment)
    f = np.arange(grid.nx, dtype=np.float64)[None, :].repeat(ny, 0)
    out = (ell.w * f.reshape(-1)[ell.idx]).sum(axis=1).reshape(ny, nxp)
    exact = 0.5 * (f[:, :-1] + f[:, 1:])
    for j in (0, ny - 1):
        err = np.abs(out[j, 1:-1] - exact[j, :])
        assert err.max() <= SLACK + 1e-6, err.max()
