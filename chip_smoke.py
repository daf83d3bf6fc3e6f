#!/usr/bin/env python3
"""Smoke test of the regrid pipeline on NVIDIA GPUs.

    python3 chip_smoke.py [--ncells N]              # one card
    python3 chip_smoke.py --four-cards [--ncells N]  # four cards

One card, in order (any failure exits non-zero):

1. Device: JAX must find a GPU. Prints device_kind, the device count and
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
2. Main path: builds the production inputs (a seeded synthetic MPAS mesh
   of --ncells cells, default 2.6M; parm/ varlists + vorticity, nz=55,
   nsoil=4, 973 columns) and runs ``python -m mpassit_jax <namelist>`` on
   the 1801x1061 3-km Lambert target, in memory and streamed. The two
   files must be byte-identical and hold every variable with its schema.
3. Correctness: each ELL operator's weights applied in float64 NumPy,
   independent of mpassit_jax.ops, on 64 fixed random 32x32 tiles with
   all columns, against what the pipeline wrote, for every apply_precision
   mode; max|out - ref| / max|ref| per variable must stay within 2e-6
   (5e-5 for split_bf16) — a TF32 product (~1e-3) fails.
4. compute_dtype='float64' on the same target with a reduced column set,
   within 1e-12 of the float64 reference.
5. Peak device memory and the pipeline's stage times, informational only.

``--four-cards`` runs only the sharded comparison: the same inputs at
n_device_shards=4 for source_decomp replicate, allgather and ring against
one card, all at apply_precision='highest' (replicate byte-identical, the
others within 1e-6), and checks that the device mesh spans four distinct
cards.

The script itself stays off the GPU until every pipeline process has run
(one JAX process per card). Work files live in .bench_cache/smoke of the
checkout and are removed at the end; the pipeline logs go to
chiprun_out/smoke/. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the package is imported first: outside a checkout the script fails here,
# before it prints anything
from mpassit_jax.config import Config  # noqa: E402
from mpassit_jax.constants import PROJ_LC  # noqa: E402
from mpassit_jax.fields.registry import build_routing  # noqa: E402
from mpassit_jax.grids.target import build_target_grid  # noqa: E402
from mpassit_jax.io.nc4 import ClassicFile  # noqa: E402
from mpassit_jax.io.wrf_writer import NC_FILL_FLOAT  # noqa: E402
from mpassit_jax.mesh.mpas import mesh_from_file  # noqa: E402
from mpassit_jax.mesh.reorder import reorder_cells_morton  # noqa: E402
from tools import bench_production as prod  # noqa: E402

TILE = 32
N_TILES = 64
SEED = 20240325
MODE_TOL = {"split6_bf16": 2e-6, "highest": 2e-6, "split_bf16": 5e-5}
F64_TOL = 1e-12
SHARDED_TOL = 1e-6
#: the float64 run's reduced varlists: every 2-D hist field (bilinear,
#: conserve, nearest), theta (nz), the winds (mass bilinear, Q4 rotation,
#: edge restagger), vorticity (vertex) and tslb (soil): 230 columns
F64_VARLISTS = {
    "diaglist": "",
    "histlist_2d": ("surface_pressure PSFC\nxland XLAND\nskintemp TSK\n"
                    "snow SNOW\nsnowh SNOWH\nsst SST\n"),
    "histlist_3d": ("theta T\nuReconstructZonal U\n"
                    "uReconstructMeridional V\nvorticity VORT\n"),
    "histlist_soil": "tslb TSLB\n",
}
D2 = ("Time", "south_north", "west_east")
D3 = ("Time", "bottom_top", "south_north", "west_east")
D3P = ("Time", "bottom_top_stag", "south_north", "west_east")
D3S = ("Time", "soil_layers_stag", "south_north", "west_east")
STATIC = {"XLONG": D2, "XLAT": D2, "MAPFAC_M": D2, "SINALPHA": D2,
          "COSALPHA": D2, "HGT": D2, "Z_C": D3P, "ITIMESTEP": ("Time",),
          "XTIME": ("Time",), "Times": ("Time", "StrLen"),
          "ZS": ("Time", "soil_layers_stag"), "P_TOP": ("Time",),
          "MU": D3, "PB": D3, "PH": D3P, "P": D3,
          "U": ("Time", "bottom_top", "south_north", "west_east_stag"),
          "V": ("Time", "bottom_top", "south_north_stag", "west_east")}


def say(msg):
    print(msg, flush=True)


# ---- phase 1: the device ----------------------------------------------------

def query_devices():
    """platform / device_kind / count, asked of JAX in a child process so
    that this process does not reserve the card before the pipeline runs."""
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        sys.exit(f"device query failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def check_device(dev, need):
    """Refuse anything but ``need`` or more GPUs (no CPU fallback)."""
    if dev["platform"] != "gpu":
        sys.exit(f"no GPU: JAX reports platform {dev['platform']!r}")
    if dev["count"] < need:
        sys.exit(f"need {need} GPUs, JAX reports {dev['count']}")


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines() if ln.strip())


def last_line(dev):
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


# ---- phase 2: the main path through the CLI ---------------------------------

def run_cli(nml, tag, log_dir, env=None):
    """``python -m mpassit_jax <nml>``; returns the parsed run summary
    (stage seconds, device peak bytes, device mesh) and the wall time."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mpassit_jax", nml],
                       cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, **(env or {})))
    wall = time.perf_counter() - t0
    text = r.stdout + r.stderr
    with open(os.path.join(log_dir, f"{tag}.log"), "w") as f:
        f.write(text)
    if r.returncode != 0:
        sys.exit(f"pipeline run {tag} exited {r.returncode}:\n{text[-4000:]}")
    info = {"wall_s": wall}
    m = re.search(r"^- timings: (\{.*\})$", text, re.M)
    info["stages"] = json.loads(m.group(1)) if m else {}
    m = re.search(r"^- device peak bytes in use: (\d+)$", text, re.M)
    info["peak_bytes"] = int(m.group(1)) if m else None
    m = re.search(r"^- device mesh: (\d+) devices \((.*)\)$", text, re.M)
    info["mesh"] = (int(m.group(1)), m.group(2)) if m else None
    return info


def write_namelist(work, d, out, stream, **extra):
    path = os.path.join(work, "namelist." + os.path.basename(out))
    with open(path, "w") as f:
        f.write(prod._namelist_text(d, os.path.join(work, "weights"), out,
                                    stream, **extra))
    return path


def files_identical(a, b, chunk=1 << 26):
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def expected_schema(routing, wrf_mod):
    """out_name -> dims of every variable the run must write."""
    exp = dict(STATIC)
    for s in routing.diag:
        exp[s.out_name] = D3 if s.in_name == "refl10cm" else D2
    for s in routing.patch_2d + routing.cons_2d + routing.nstd_2d:
        exp[s.out_name] = D2
    for s in routing.nz_3d + routing.vert_3d:
        exp[s.out_name] = D3
    for s in routing.nzp1_3d:
        exp[s.out_name] = D3P
    for s in routing.soil:
        exp[s.out_name] = D3S
    if not wrf_mod:
        for k in ("MU", "PB", "PH", "P", "P_TOP"):
            exp.pop(k)
    return exp


def check_schema(path, exp):
    with ClassicFile(path) as f:
        missing = sorted(set(exp) - set(f.var_names()))
        if missing:
            sys.exit(f"{path}: variables missing: {missing}")
        for name, dims in exp.items():
            if tuple(f.var_dims(name)) != dims:
                sys.exit(f"{path}: {name} has dims {f.var_dims(name)}, "
                         f"expected {dims}")
            kind = f.var_view(name).dtype
            want = {"Times": "S", "ITIMESTEP": "i"}.get(name, "f")
            if kind.kind != want or (want == "f" and kind.itemsize != 4):
                sys.exit(f"{path}: {name} has dtype {kind}")
    return len(exp)


# ---- phase 3/4: the float64 reference ---------------------------------------

def tile_points(ny, nx, seed):
    """Flattened (y, x) of N_TILES fixed random full 32x32 tiles."""
    rng = np.random.default_rng(seed)
    ty = rng.integers(0, ny // TILE, N_TILES)
    tx = rng.integers(0, nx // TILE, N_TILES)
    r = np.arange(TILE)
    yy = ty[:, None, None] * TILE + r[None, :, None] + 0 * r[None, None, :]
    xx = tx[:, None, None] * TILE + r[None, None, :] + 0 * r[None, :, None]
    return yy.ravel(), xx.ravel()


def ell_ref(ell, t, rows_fn):
    """sum_k w[t, k] * src[idx[t, k]] in float64; rows_fn(rows) -> the
    (len(rows), C) source rows."""
    idx = np.asarray(ell.idx)[t]
    w = np.asarray(ell.w, np.float64)[t]
    vals = rows_fn(idx.ravel()).reshape(idx.shape + (-1,))
    return np.einsum("nk,nkc->nc", w, vals)


def rotate_ref(u, v, cosa, sina):
    """The Q4 sequential rotation of ops/rotate.py, in NumPy f64."""
    cosa, sina = cosa[:, None], sina[:, None]
    tana = sina / cosa
    u_new = (u + v * tana) / (cosa + sina * tana)
    return u_new, (v - u_new * sina) / cosa


class Reference:
    """Float64 reference of every regridded variable of a run, at the
    sample points. Setup (grid, mesh, Morton order, weights from the
    run's weight cache) reuses the pipeline's own builders; the apply is
    the plain ELL sum above."""

    def __init__(self, nml):
        from mpassit_jax.run.pipeline import build_weights

        self.cfg = cfg = Config.from_namelist(nml)
        self.grid = grid = build_target_grid(cfg)
        self.lambert = cfg.proj_code == PROJ_LC
        ro = reorder_cells_morton(mesh_from_file(cfg.grid_file_input_grid),
                                  grid.proj)
        self.perm, self.mesh = ro.perm, ro.mesh
        self.routing = build_routing(cfg.varlist_dir, cfg.interp_diag,
                                     cfg.interp_hist, cfg.wrf_mod_vars)
        self.w = build_weights(cfg, self.mesh, grid, self.routing)
        ny, nx = grid.shape
        self.pts = {"mass": tile_points(ny, nx, SEED),
                    "u": tile_points(ny, nx + 1, SEED + 1),
                    "v": tile_points(ny + 1, nx, SEED + 2)}
        self.t = {"mass": self.pts["mass"][0] * nx + self.pts["mass"][1],
                  "u": self.pts["u"][0] * (nx + 1) + self.pts["u"][1],
                  "v": self.pts["v"][0] * nx + self.pts["v"][1]}

    def _rows(self, f, name, vertex=False):
        view = f.var_view(name)[0]
        perm = self.perm

        def rows(r):
            a = view[r] if vertex else view[perm[r]]
            a = np.asarray(a, np.float64)
            return a[:, None] if a.ndim == 1 else a
        return rows

    def raw(self):
        """key -> (grid, (n_pts, nlev) f64): keys are the pipeline's
        result names ("nz3d.T", "u", "hgt", ...), values before the
        writer's transforms."""
        cfg, r, w, t = self.cfg, self.routing, self.w, self.t["mass"]
        out = {}
        if cfg.interp_diag:
            with ClassicFile(cfg.diag_file_input_grid) as f:
                for s in r.diag:
                    out[f"diag.{s.out_name}"] = ("mass", ell_ref(
                        w["bilinear"], t, self._rows(f, s.in_name)))
            names = {s.in_name: s.out_name for s in r.diag}
            if "u10" in names and "v10" in names and self.lambert:
                ku, kv = f"diag.{names['u10']}", f"diag.{names['v10']}"
                cs = self.grid.cosa.reshape(-1)[t]
                sn = self.grid.sina.reshape(-1)[t]
                u, v = rotate_ref(out[ku][1], out[kv][1], cs, sn)
                out[ku], out[kv] = ("mass", u), ("mass", v)
            for k in [k for k in out if k.startswith("diag.")]:
                cat = "diag2d" if out[k][1].shape[1] == 1 else "diag3d"
                out[cat + k[4:]] = out.pop(k)
        if not cfg.interp_hist:
            return out
        with ClassicFile(cfg.hist_file_input_grid) as f:
            cats = (("patch2d", r.patch_2d, "bilinear"),
                    ("cons2d", r.cons_2d, "conserve"),
                    ("nstd2d", r.nstd_2d, "nearest"),
                    ("soil", r.soil, r.soil_method()),
                    ("nz3d", r.nz_3d, "bilinear"),
                    ("nzp13d", r.nzp1_3d, "bilinear"),
                    ("vert3d", r.vert_3d, "vertex"))
            for cat, specs, method in cats:
                for s in specs:
                    out[f"{cat}.{s.out_name}"] = ("mass", ell_ref(
                        w[method], t, self._rows(f, s.in_name,
                                                 vertex=cat == "vert3d")))
            out["hgt"] = ("mass", ell_ref(
                w["bilinear"], t, lambda rr: self.mesh.ter[rr][:, None]))
            if r.do_u and r.do_v:
                out.update(self._winds(f))
        return out

    def _winds(self, f):
        """Staggered winds: mass-point bilinear, Q4 rotation (Lambert),
        then the edge restagger operator."""
        b = self.w["bilinear"]
        res = {}
        for key, edge in (("u", "edge1"), ("v", "edge2")):
            ell = self.w[edge]
            need = np.unique(np.asarray(ell.idx)[self.t[key]])
            mu = ell_ref(b, need, self._rows(f, "uReconstructZonal"))
            mv = ell_ref(b, need, self._rows(f, "uReconstructMeridional"))
            if self.lambert:
                mu, mv = rotate_ref(mu, mv, self.grid.cosa.reshape(-1)[need],
                                    self.grid.sina.reshape(-1)[need])
            mass = mu if key == "u" else mv
            pos = np.searchsorted(need, np.arange(need.max() + 1))
            res[key] = (key, ell_ref(ell, self.t[key], lambda rr: mass[pos[rr]]))
        return res


def rel_err(got, ref):
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / (scale if scale else 1.0))


def sharded_err(name, one, got):
    """rel_err over the values the writer did not leave at the fill value
    (Z_C's top level); T is compared as T + 300 (see compare_file)."""
    keep = one != NC_FILL_FLOAT
    off = 300.0 if name == "T" else 0.0
    return rel_err(np.asarray(got[keep], np.float64) + off,
                   np.asarray(one[keep], np.float64) + off)


def file_sample(f, name, yy, xx):
    v = f.var_view(name)[0]
    if v.ndim == 2:
        return np.asarray(v[yy, xx], np.float64)[:, None]
    return np.asarray(v[:, yy, xx], np.float64).T


def compare_file(path, ref, raw, nz, wrf_mod):
    """Per-variable max|out - ref| / max|ref| of a written file against
    the f64 reference. The writer's transforms are applied to the
    reference (PHB = 9.81 zgrid, Z_C = zgrid midpoints, PB = P_HYD),
    except T = theta - 300, compared as T + 300 against theta: the
    subtraction cancels most of theta's magnitude, so comparing T itself
    would measure the f32 rounding of theta, not the apply."""
    errs = {}
    with ClassicFile(path) as f:
        for key, (g, r) in raw.items():
            name = {"hgt": "HGT", "u": "U", "v": "V"}.get(
                key, key.split(".", 1)[-1])
            yy, xx = ref.pts[g]
            got = file_sample(f, name, yy, xx)
            if wrf_mod and key == "nz3d.T":
                got = got + 300.0
            if wrf_mod and key.startswith("nzp13d.") and name == "PHB":
                zc = file_sample(f, "Z_C", yy, xx)[:, :nz]
                errs["Z_C"] = rel_err(zc, 0.5 * (r[:, 1:] + r[:, :-1]))
                r = 9.81 * r
            if wrf_mod and key.startswith("nz3d.") and name == "P_HYD":
                errs["PB"] = rel_err(file_sample(f, "PB", yy, xx), r)
            errs[name] = rel_err(got, r)
        if wrf_mod:
            yy, xx = ref.pts["mass"]
            for name in ("MU", "P", "PH"):
                if np.any(file_sample(f, name, yy, xx)):
                    errs[name] = float("inf")
    return errs


def check_errs(errs, tol, what):
    worst = max(errs, key=errs.get)
    bad = {k: v for k, v in errs.items() if not v <= tol}
    say(f"- {what}: worst {worst} {errs[worst]:.3e} over {len(errs)} "
        f"variables (tolerance {tol:g})")
    if bad:
        sys.exit(f"{what}: over tolerance {tol:g}: {bad}")


def compare_dump(npz, ref, raw):
    """The float64 run's pre-write results (MPASSIT_DUMP_RESULT) against
    the reference."""
    errs = {}
    with np.load(npz) as z:
        for key, (g, r) in raw.items():
            yy, xx = ref.pts[g]
            a = z[key]
            got = a[yy, xx] if a.ndim == 2 else a[yy, xx, :]
            got = np.asarray(got, np.float64).reshape(r.shape)
            errs[key] = rel_err(got, r)
    return errs


# ---- the runs ----------------------------------------------------------------

def one_card(work, log_dir, ncells):
    dev = query_devices()
    check_device(dev, 1)
    say(f"device: {dev['kind']} x{dev['count']} | {card_line()}")

    t0 = time.perf_counter()
    d = prod.build_inputs(work, ncells=ncells)
    say(f"- inputs: {ncells} cells -> {prod.NX}x{prod.NY}, nz={prod.NZ}, "
        f"{sum(os.path.getsize(os.path.join(d, n)) for n in ('grid.nc', 'diag.nc', 'hist.nc')) / 1e9:.2f} GB "
        f"({time.perf_counter() - t0:.0f} s)")

    runs, outs = {}, {}
    for tag, stream in (("in_memory", False), ("streamed", True)):
        outs[tag] = os.path.join(work, f"out_{tag}.nc")
        runs[tag] = run_cli(write_namelist(work, d, outs[tag], stream), tag,
                            log_dir)
        say(f"- main path {tag}: {runs[tag]['wall_s']:.1f} s wall")
    if not files_identical(outs["in_memory"], outs["streamed"]):
        sys.exit("in-memory and streamed output files differ")
    ref = Reference(write_namelist(work, d, outs["in_memory"], False))
    n_vars = check_schema(outs["streamed"], expected_schema(
        ref.routing, ref.cfg.wrf_mod_vars))
    say(f"- main path: files byte-identical "
        f"({os.path.getsize(outs['streamed']) / 1e9:.2f} GB), "
        f"{n_vars} variables with their schema")
    os.remove(outs["in_memory"])

    t0 = time.perf_counter()
    raw = ref.raw()
    say(f"- reference: {len(raw)} variables on {N_TILES} tiles per grid "
        f"({time.perf_counter() - t0:.0f} s)")
    for mode in ("split6_bf16", "highest", "split_bf16"):
        if mode == ref.cfg.apply_precision:
            path = outs["streamed"]
        else:
            path = os.path.join(work, f"out_{mode}.nc")
            info = run_cli(write_namelist(
                work, d, path, True, apply_precision=f"'{mode}'"), mode,
                log_dir)
            say(f"- main path {mode}: {info['wall_s']:.1f} s wall")
        check_errs(compare_file(path, ref, raw, prod.NZ,
                                ref.cfg.wrf_mod_vars),
                   MODE_TOL[mode], f"apply_precision={mode}")
        os.remove(path)

    vd = os.path.join(work, "parm_f64")
    os.makedirs(vd, exist_ok=True)
    for name, text in F64_VARLISTS.items():
        with open(os.path.join(vd, name), "w") as f:
            f.write(text)
    out64 = os.path.join(work, "out_f64.nc")
    npz = os.path.join(work, "f64_result.npz")
    nml = write_namelist(work, d, out64, False, interp_diag=".false.",
                         compute_dtype="'float64'")
    with open(nml) as f:
        text = f.read().replace(os.path.join(d, "parm"), vd)
    with open(nml, "w") as f:
        f.write(text)
    info = run_cli(nml, "float64", log_dir, env={"MPASSIT_DUMP_RESULT": npz})
    ref64 = Reference(nml)
    raw64 = ref64.raw()
    n_cols = sum(r.shape[1] for k, (_, r) in raw64.items() if k != "hgt")
    say(f"- float64 run: {info['wall_s']:.1f} s wall, {n_cols} columns "
        f"(theta, winds, vorticity, tslb, six 2-D fields)")
    check_errs(compare_dump(npz, ref64, raw64), F64_TOL,
               "compute_dtype=float64")

    for tag in ("in_memory", "streamed"):
        say(f"- info only, not a benchmark number: {tag} run device peak "
            f"bytes in use {runs[tag]['peak_bytes']}, stage seconds "
            f"{json.dumps(runs[tag]['stages'])}")
    return dev


def four_cards(work, log_dir, ncells):
    dev = query_devices()
    check_device(dev, 4)
    say(f"device: {dev['kind']} x{dev['count']} | {card_line()}")
    d = prod.build_inputs(work, ncells=ncells)
    say(f"- inputs: {ncells} cells -> {prod.NX}x{prod.NY}, nz={prod.NZ}")
    # every run at apply_precision='highest': allgather and ring take the
    # f32 gather engine, so against the default split6_bf16 (~1e-6 of the
    # f64 apply at this size) the 1e-6 bound would measure the precision
    # mode, not the sharding
    prec = {"apply_precision": "'highest'"}
    one = os.path.join(work, "out_1card.nc")
    info = run_cli(write_namelist(work, d, one, False, **prec), "1card",
                   log_dir)
    say(f"- one card: {info['wall_s']:.1f} s wall")
    failed = []     # every decomposition is compared before the verdict
    for decomp in ("replicate", "allgather", "ring"):
        out = os.path.join(work, f"out_4card_{decomp}.nc")
        info = run_cli(write_namelist(work, d, out, False, n_device_shards=4,
                                      source_decomp=f"'{decomp}'", **prec),
                       f"4card_{decomp}", log_dir)
        n_dev, names = info["mesh"] or (0, "")
        if n_dev != 4 or len(set(names.split(", "))) != 4:
            sys.exit(f"{decomp}: the run's device mesh is {info['mesh']}")
        with ClassicFile(one) as a, ClassicFile(out) as b:
            errs = {n: sharded_err(n, a.read_var(n), b.read_var(n))
                    for n in a.var_names()
                    if a.var_view(n).dtype.kind == "f"}
        if decomp == "replicate":
            same = files_identical(one, out)
            say(f"- four cards replicate: {info['wall_s']:.1f} s wall, "
                f"{'byte-identical to' if same else 'DIFFERS from'} one card")
            if not same:
                failed.append(f"replicate differs from one card: "
                              f"{ {k: v for k, v in errs.items() if v} }")
        else:
            worst = max(errs, key=errs.get)
            say(f"- four cards {decomp}: {info['wall_s']:.1f} s wall, worst "
                f"{worst} {errs[worst]:.3e} vs one card (tolerance "
                f"{SHARDED_TOL:g})")
            bad = {k: v for k, v in errs.items() if not v <= SHARDED_TOL}
            if bad:
                failed.append(f"{decomp} over tolerance: {bad}")
        os.remove(out)

    # the mesh the pipeline builds spans four distinct cards, and a sharded
    # array lands one shard on each (the parent reaches the GPU only now)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpassit_jax.parallel.sharding import GRID_AXIS, make_grid_mesh

    mesh = make_grid_mesh(jax.devices()[:4])
    x = jax.device_put(np.zeros((8, 128), np.float32),
                       NamedSharding(mesh, P(GRID_AXIS)))
    on = {s.device for s in x.addressable_shards}
    if len(set(mesh.devices.flat)) != 4 or len(on) != 4:
        sys.exit(f"mesh {mesh.devices} places shards on {on}")
    say(f"- device mesh: {', '.join(str(d) for d in mesh.devices.flat)}")
    if failed:
        sys.exit("four cards: " + "; ".join(failed))
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded comparison")
    ap.add_argument("--ncells", type=int, default=prod.NCELLS,
                    help="source mesh cells (default %(default)s)")
    args = ap.parse_args(argv)
    if args.ncells != prod.NCELLS:
        say(f"- source cut: {args.ncells} cells instead of {prod.NCELLS}")
    work = os.path.join(REPO, ".bench_cache", "smoke")
    log_dir = os.path.join(REPO, "chiprun_out", "smoke")
    os.makedirs(work, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    need = 4 if args.four_cards else 1
    try:
        (four_cards if args.four_cards else one_card)(
            work, log_dir, args.ncells)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"- smoke passed in {time.perf_counter() - t0:.0f} s")
    import jax

    d = jax.devices()
    dev = {"platform": d[0].platform, "kind": d[0].device_kind,
           "count": len(d)}
    check_device(dev, need)
    print(last_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
