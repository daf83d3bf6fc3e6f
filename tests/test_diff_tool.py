"""tools/diff_against_reference.py — the one-command parity check must
itself be proven to work before a real MPASSIT output file shows up:
self-comparison passes, perturbations fail, known-deviation vars report
separately, Q5 unmapped masking engages."""

import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from test_pipeline import make_case

from mpassit_jax.io.nc4 import ClassicFile
from mpassit_jax.run.pipeline import run_pipeline

TOOL = "tools/diff_against_reference.py"


@pytest.fixture(scope="module")
def out_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("difftool")
    mesh, cfg, _, _ = make_case(d)
    run_pipeline(cfg, dtype=jnp.float32)
    return cfg.output_file


def _run(*args):
    return subprocess.run(
        [sys.executable, TOOL, *args], capture_output=True, text=True,
        cwd=__file__.rsplit("/tests/", 1)[0])


def test_self_compare_exits_zero(out_file):
    r = _run(out_file, out_file)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FAIL" not in r.stdout
    assert "match:" in r.stdout


def test_perturbed_var_fails(out_file, tmp_path):
    bad = str(tmp_path / "bad.nc")
    shutil.copy(out_file, bad)
    with ClassicFile(bad, "r+") as f:
        # well past rtol on a ~0-300 K field
        f.var_view("T")[0, 0, 3, 4] += 1.0
    r = _run(out_file, bad)
    assert r.returncode == 1
    assert "FAIL       T:" in r.stdout


def test_known_deviation_reported_not_failed(out_file, tmp_path):
    dev = str(tmp_path / "dev.nc")
    shutil.copy(out_file, dev)
    with ClassicFile(dev, "r+") as f:
        f.var_view("U")[0, 0, 0, 0] += 0.5     # U is register row R3
    r = _run(out_file, dev)
    assert r.returncode == 0, r.stdout   # deviations alone don't fail
    assert "DEVIATION  U:" in r.stdout
    assert "register row R3" in r.stdout


def test_mask_unmapped(out_file, tmp_path):
    z = str(tmp_path / "zeroed.nc")
    shutil.copy(out_file, z)
    with ClassicFile(z, "r+") as f:
        # ours==0 where ref!=0 -> Q5 suspect
        f.var_view("T")[0, 0, 1, 1] = 0.0
    r = _run(out_file, z, "--mask-unmapped")
    assert r.returncode == 0, r.stdout
    assert "unmapped-suspect" in r.stdout

    r2 = _run(out_file, z)             # without masking it is a failure
    assert r2.returncode == 1
