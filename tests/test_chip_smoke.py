"""chip_smoke.py's own logic, on the CPU: it refuses any device but a GPU,
its last line has the contract's shape, --four-cards runs only its
phase, and its float64 reference helpers compute what they claim."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.check_device({"platform": "cpu", "kind": "cpu", "count": 8}, 1)
    assert e.value.code not in (0, None)


def test_device_check_counts_cards():
    with pytest.raises(SystemExit):
        cs.check_device({"platform": "gpu", "kind": "H100", "count": 1}, 4)
    cs.check_device({"platform": "gpu", "kind": "H100", "count": 4}, 4)


def test_last_line_format():
    line = cs.last_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": 1})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("argv,want", [([], "one_card"),
                                       (["--four-cards"], "four_cards")])
def test_option_selects_only_its_phase(monkeypatch, capsys, argv, want):
    calls = []
    monkeypatch.setattr(cs, "one_card", lambda *a: calls.append("one_card"))
    monkeypatch.setattr(cs, "four_cards",
                        lambda *a: calls.append("four_cards"))
    monkeypatch.setattr(cs, "check_device", lambda dev, need: None)
    monkeypatch.setattr(cs.shutil, "rmtree", lambda *a, **k: None)
    assert cs.main(argv) == 0
    assert calls == [want]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(last)) == {"ok", "device"}


def test_tile_points_are_fixed_full_tiles():
    yy, xx = cs.tile_points(1061, 1801, cs.SEED)
    yy2, xx2 = cs.tile_points(1061, 1801, cs.SEED)
    assert (yy == yy2).all() and (xx == xx2).all()
    assert yy.size == cs.N_TILES * cs.TILE * cs.TILE
    assert yy.max() < 1061 // 32 * 32 and xx.max() < 1801 // 32 * 32
    t = yy.reshape(cs.N_TILES, 32, 32)
    assert (np.diff(t, axis=1) == 1).all()


def test_reference_helpers():
    """ell_ref is sum_k w * src[idx]; rotate_ref is the Q4 formula of
    ops/rotate.py."""
    import jax.numpy as jnp

    from mpassit_jax.ops.rotate import rotate_winds
    from mpassit_jax.weights.ell import ELLWeights

    rng = np.random.default_rng(0)
    src = rng.standard_normal((50, 3))
    ell = ELLWeights(idx=rng.integers(0, 50, (20, 4)).astype(np.int32),
                     w=rng.random((20, 4)), n_src=50, method="bilinear",
                     dst_shape=(4, 5))
    t = np.array([0, 7, 19])
    want = np.stack([sum(ell.w[i, k] * src[ell.idx[i, k]] for k in range(4))
                     for i in t])
    np.testing.assert_allclose(cs.ell_ref(ell, t, lambda r: src[r]), want,
                               rtol=1e-14)
    u, v = rng.standard_normal((2, 6, 1))
    a = rng.uniform(-1, 1, 6)
    ur, vr = cs.rotate_ref(u, v, np.cos(a), np.sin(a))
    uj, vj = rotate_winds(jnp.asarray(u[:, 0]), jnp.asarray(v[:, 0]),
                          jnp.asarray(np.cos(a)), jnp.asarray(np.sin(a)))
    np.testing.assert_allclose(ur[:, 0], np.asarray(uj), rtol=1e-12)
    np.testing.assert_allclose(vr[:, 0], np.asarray(vj), rtol=1e-12)


def test_sharded_err_skips_fill_and_offsets_t():
    one = np.array([1.0, 2.0, cs.NC_FILL_FLOAT], np.float32)
    got = np.array([1.0, 2.0 + 2e-6, 0.0], np.float32)
    assert cs.sharded_err("W", one, got) == pytest.approx(1e-6, rel=0.1)
    assert cs.sharded_err("T", one, got) < 1e-8
