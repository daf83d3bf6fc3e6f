"""Device budget of the grouped apply: the device's reported bytes_limit,
MPASSIT_DEVICE_BUDGET_GB only where the backend reports none (the CPU),
and no bound at all without either."""

import numpy as np
import pytest

import jax

from mpassit_jax.ops import matmul_apply as ma
from mpassit_jax.weights.ell import ELLWeights


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _stub(monkeypatch, stats):
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(stats)])


def test_budget_is_the_reported_limit(monkeypatch):
    _stub(monkeypatch, {"bytes_limit": 60_000_000_000,
                        "peak_bytes_in_use": 1})
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", "0.001")  # ignored
    assert ma.device_budget_bytes() == 60e9


def test_env_only_without_a_limit(monkeypatch):
    _stub(monkeypatch, None)
    monkeypatch.setenv("MPASSIT_DEVICE_BUDGET_GB", "2.5")
    assert ma.device_budget_bytes() == 2.5e9
    _stub(monkeypatch, {"bytes_in_use": 0})
    assert ma.device_budget_bytes() == 2.5e9


def test_no_limit_no_env_is_unbounded(monkeypatch):
    _stub(monkeypatch, None)
    monkeypatch.delenv("MPASSIT_DEVICE_BUDGET_GB", raising=False)
    assert ma.device_budget_bytes() is None


@pytest.mark.parametrize("limit,grouped", [(1e12, False), (1e6, True)])
def test_grouped_width_follows_the_limit(monkeypatch, limit, grouped):
    rng = np.random.default_rng(2)
    ny, nx, n_src = 40, 70, 200
    ell = ELLWeights(idx=rng.integers(0, n_src, (ny * nx, 3)).astype(np.int32),
                     w=rng.random((ny * nx, 3)), n_src=n_src,
                     method="bilinear", dst_shape=(ny, nx))
    pk = ma.PackedSlabRegridder([(ell, 600)])
    _stub(monkeypatch, {"bytes_limit": limit})
    gw = pk._grouped_width()
    assert (gw > 0) == grouped
    if grouped:
        assert gw < pk.Cp and gw % ma.LANE == 0
