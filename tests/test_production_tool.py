"""tools/bench_production.py contracts: the input builder produces files
the pipeline can consume at the full parm/ variable load (973-col layout
scaled to the test nz), and the namelist/Config agree."""

import importlib
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture()
def prod(monkeypatch, tmp_path):
    monkeypatch.setenv("PROD_NCELLS", "4000")
    monkeypatch.setenv("PROD_NZ", "5")
    monkeypatch.setenv("PROD_NX", "31")
    monkeypatch.setenv("PROD_NY", "23")
    import tools.bench_production as bp

    importlib.reload(bp)
    yield bp, str(tmp_path)
    for k in ("PROD_NCELLS", "PROD_NZ", "PROD_NX", "PROD_NY"):
        monkeypatch.delenv(k)
    importlib.reload(bp)          # restore module-level production sizes


def test_build_inputs_feed_the_full_pipeline(prod):
    bp, cache = prod
    d = bp.build_inputs(cache)
    # idempotent: the stamp short-circuits a rebuild
    assert bp.build_inputs(cache) == d
    for f in ("grid.nc", "hist.nc", "diag.nc", "parm/diaglist",
              "parm/histlist_3d"):
        assert os.path.exists(os.path.join(d, f)), f
    with open(os.path.join(d, "parm", "histlist_3d")) as fh:
        assert "vorticity VORT" in fh.read()

    from mpassit_jax.run.pipeline import run_pipeline

    cfg = bp._make_config(d, cache, os.path.join(d, "out.nc"), stream=True)
    art = run_pipeline(cfg, dtype=jnp.float32)
    from mpassit_jax.io.nc4 import open_dataset

    with open_dataset(cfg.output_file) as f:
        names = f.var_names()
        # the full parm/ load made it through: every output var present
        for v in ("RAINC", "REFL_10CM", "U10", "T", "PHB", "QVAPOR",
                  "P_HYD", "MUB", "VORT", "TSLB", "SH2O", "SNOWH", "SST",
                  "PSFC", "U", "V", "Z_C", "P_TOP"):
            assert v in names, v
        t = np.asarray(f.read_var("T"))
        assert t.shape[1] == 5 and np.isfinite(t).all()

    # namelist text and Config build the same run
    nml = os.path.join(d, "check.nml")
    with open(nml, "w") as fh:
        fh.write(bp._namelist_text(d, cache, os.path.join(d, "o2.nc"),
                                   stream=True))
    from mpassit_jax.config import Config

    cfg2 = Config.from_namelist(nml)
    assert cfg2.stream_output and cfg2.i_target == cfg.i_target
    assert cfg2.varlist_dir == cfg.varlist_dir
