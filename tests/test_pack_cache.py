"""Packed-operator disk cache (VERDICT r3 item 4).

The host-side union pack (_pack_union) is ~8 s per warm run at CONUS scale;
it is a pure function of the ELL operators + tile geometry, so it caches
exactly like the weights do. These tests pin: cache hit == fresh build
bit-for-bit, content-keyed invalidation, and corrupt-entry rebuild.
"""

import numpy as np
import pytest

from mpassit_jax.ops.matmul_apply import (
    PackedSlabRegridder,
    SlabMatmulRegridder,
    _pack_cache_path,
)
from mpassit_jax.weights.ell import ELLWeights


def _rand_ell(rng, T_shape, n_src, K):
    T = T_shape[0] * T_shape[1]
    idx = rng.integers(0, n_src, size=(T, K)).astype(np.int32)
    w = rng.random((T, K))
    w[rng.random((T, K)) < 0.2] = 0.0        # padding rows/entries
    return ELLWeights(idx=idx, w=w, n_src=n_src, method="bilinear",
                      dst_shape=T_shape)


@pytest.fixture
def ells():
    rng = np.random.default_rng(3)
    shape = (40, 70)
    # 200 sources: a tile's unique rows stay under W_CAP
    return (_rand_ell(rng, shape, 200, 3), _rand_ell(rng, shape, 200, 1))


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a.slab_idx), np.asarray(b.slab_idx))
    assert a.W == b.W and a.n_tiles == b.n_tiles
    As_a = a.As if hasattr(a, "As") else [a.A]
    As_b = b.As if hasattr(b, "As") else [b.A]
    for Aa, Ab in zip(As_a, As_b):
        np.testing.assert_array_equal(np.asarray(Aa), np.asarray(Ab))


def test_slab_cache_roundtrip(tmp_path, ells):
    ell = ells[0]
    fresh = SlabMatmulRegridder(ell, precision="highest")
    first = SlabMatmulRegridder(ell, precision="highest",
                                cache_dir=str(tmp_path))
    path = _pack_cache_path(str(tmp_path), (ell.fingerprint(),), 40, 70, 1)
    import os
    assert os.path.exists(path)
    warm = SlabMatmulRegridder(ell, precision="highest",
                               cache_dir=str(tmp_path))
    _assert_same(fresh, first)
    _assert_same(first, warm)
    # apply result identical through the cache
    src = np.random.default_rng(0).random((200, 4)).astype(np.float32)
    np.testing.assert_array_equal(fresh.apply_np(src), warm.apply_np(src))


def test_packed_cache_roundtrip_and_invalidation(tmp_path, ells):
    ea, eb = ells
    spec = [(ea, 5), (eb, 2)]
    fresh = PackedSlabRegridder(spec, precision="highest")
    PackedSlabRegridder(spec, precision="highest", cache_dir=str(tmp_path))
    warm = PackedSlabRegridder(spec, precision="highest",
                               cache_dir=str(tmp_path))
    _assert_same(fresh, warm)
    # changing any weight changes the key -> a DIFFERENT cache entry
    eb2 = ELLWeights(idx=eb.idx, w=eb.w * 0.5, n_src=eb.n_src,
                     method=eb.method, dst_shape=eb.dst_shape)
    pa = _pack_cache_path(str(tmp_path),
                          (ea.fingerprint(), eb.fingerprint()), 40, 70, 1)
    pb = _pack_cache_path(str(tmp_path),
                          (ea.fingerprint(), eb2.fingerprint()), 40, 70, 1)
    assert pa != pb


def test_corrupt_cache_entry_rebuilds(tmp_path, ells):
    ell = ells[0]
    fresh = SlabMatmulRegridder(ell, precision="highest")
    SlabMatmulRegridder(ell, precision="highest", cache_dir=str(tmp_path))
    path = _pack_cache_path(str(tmp_path), (ell.fingerprint(),), 40, 70, 1)
    import os
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write("{ garbage")
    for fn in os.listdir(path):
        if fn.endswith(".npy"):
            with open(os.path.join(path, fn), "wb") as f:
                f.write(b"garbage not an npy")
    rebuilt = SlabMatmulRegridder(ell, precision="highest",
                                  cache_dir=str(tmp_path))
    _assert_same(fresh, rebuilt)


def test_fingerprint_content_keyed(ells):
    ea, eb = ells
    assert ea.fingerprint() != eb.fingerprint()
    clone = ELLWeights(idx=ea.idx.copy(), w=ea.w.copy(), n_src=ea.n_src,
                       method=ea.method, dst_shape=ea.dst_shape)
    assert clone.fingerprint() == ea.fingerprint()
