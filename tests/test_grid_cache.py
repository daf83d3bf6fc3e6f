"""Target-grid disk cache: cache hit must reproduce the built grid
bit-for-bit, including the CEN_LAT/CEN_LON config overwrite
(model_grid.F90:1107), and the key must be stable across reruns (the
builder's ref_lat mutation must not re-key)."""

import numpy as np

from mpassit_jax.config import Config
from mpassit_jax.grids.target import (
    _GRID_FIELDS,
    _grid_cache_path,
    build_target_grid,
)


def _cfg(cache_dir=""):
    c = Config.from_dict({
        "target_grid_type": "lambert", "nx": 41, "ny": 31,
        "dx": 12000.0, "dy": 12000.0, "ref_lat": 38.5, "ref_lon": -97.5,
        "truelat1": 38.5, "stand_lon": -97.5,
    })
    c.weights_cache_dir = cache_dir
    return c


def test_grid_cache_roundtrip(tmp_path):
    fresh_cfg = _cfg()
    fresh = build_target_grid(fresh_cfg)

    c1 = _cfg(str(tmp_path))
    g1 = build_target_grid(c1)        # builds + stores
    c2 = _cfg(str(tmp_path))
    g2 = build_target_grid(c2)        # loads
    for name in _GRID_FIELDS:
        a, b, c = (getattr(fresh, name), getattr(g1, name),
                   getattr(g2, name))
        if a is None:
            assert b is None and c is None
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    # the CEN_LAT/CEN_LON overwrite replays on cache hit
    assert c2.ref_lat == c1.ref_lat == fresh_cfg.ref_lat
    assert c2.ref_lon == c1.ref_lon == fresh_cfg.ref_lon
    assert g2.proj is not None


def test_grid_cache_key_stable_after_mutation(tmp_path):
    """Re-running build_target_grid on the SAME (mutated) cfg object must
    hit the same entry — known_* anchors the key, not ref_lat."""
    c = _cfg(str(tmp_path))
    p0 = _grid_cache_path(c, str(tmp_path))
    build_target_grid(c)              # mutates c.ref_lat
    assert _grid_cache_path(c, str(tmp_path)) == p0


def test_grid_cache_corrupt_entry_rebuilds(tmp_path):
    c = _cfg(str(tmp_path))
    g1 = build_target_grid(c)
    import os

    path = _grid_cache_path(_cfg(str(tmp_path)), str(tmp_path))
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{ garbage")
    g2 = build_target_grid(_cfg(str(tmp_path)))
    np.testing.assert_array_equal(g1.lat, g2.lat)


def test_grid_cache_key_differs_per_domain(tmp_path):
    a = _grid_cache_path(_cfg(str(tmp_path)), str(tmp_path))
    c = _cfg(str(tmp_path))
    c.truelat1 = 40.0
    b = _grid_cache_path(c, str(tmp_path))
    assert a != b
