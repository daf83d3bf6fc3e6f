"""Production-shape end-to-end run of the pipeline.

Runs the pipeline at the production envelope the reference MPASSIT
documents (its README: 1801x1061 3-km Lambert CONUS from a
multi-million-cell MPAS run; ~7.4 GB of output here):

- source: 2.6M-cell synthetic Voronoi mesh, nz=55, nsoil=4 (the 15-km
  global analog)
- variable load: the DEFAULT parm/ varlists plus a vorticity line (973
  columns: 18+nz diag, 3 patch, 2 cons, 1 nstd, 11*nz, 2*nzp1, nz vertex,
  2*nz winds, 3*nsoil soil)
- input files written at f32 (~11 GB), ingest bounded (f32 blocks,
  device-side assembly), output streamed (stream_output=.true.) and in
  memory

Each writer's pipeline runs in its OWN subprocess (process-cold, disk
caches warm, one process per forecast hour), recording wall clock, stage
breakdown and peak host RSS; the parent never touches the accelerator,
so each child has the device to itself. The two outputs are compared
bit-for-bit. ``build_inputs`` is shared with chip_smoke.py.

Usage: python tools/bench_production.py [--rss-only]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

NCELLS = int(os.environ.get("PROD_NCELLS", 2_600_000))
NZ = int(os.environ.get("PROD_NZ", 55))
NSOIL = 4
NX = int(os.environ.get("PROD_NX", 1801))
NY = int(os.environ.get("PROD_NY", 1061))

#: stated peak-host-RSS budget for the STREAMED production run (MB): ~11
#: GB resident input fields (f32; the reference's ranks also hold the
#: full input, input_data.F90:191-196) + up to three in-flight (ny, nx,
#: CB=256) f32 fetch strips (queue depth 2 + current, ~6 GB) + buffered
#: wind mass fields (~1.8 GB) + weights/engine/pack state (~2 GB) +
#: interpreter/JAX/allocator high-water. The structural claim is the
#: DELTA: the in-memory writer adds the full output block, which
#: streaming never materializes.
RSS_BUDGET_STREAMED_MB = 32_000


def _production_dir(cache_dir):
    return os.path.join(cache_dir, "production")


def build_inputs(cache_dir, force=False, ncells=None):
    """Write the production-scale grid/hist/diag files + varlist dir
    (once; ~11 GB on disk at 2.6M cells, reused by every run).
    ``ncells`` overrides the source cell count (default NCELLS)."""
    from bench import _cached_mesh
    from mpassit_jax.mesh.synthetic import (
        write_mpas_data_file,
        write_mpas_grid_file,
    )

    ncells = NCELLS if ncells is None else ncells
    d = _production_dir(cache_dir)
    stamp = os.path.join(d, ".complete")
    tag = f"{ncells}_{NZ}_{NSOIL}"
    if not force and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == tag:
                return d
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    mesh = _cached_mesh(cache_dir, ncells, NZ, NSOIL)
    print(f"- mesh ready ({time.perf_counter() - t0:.0f}s)", flush=True)
    write_mpas_grid_file(mesh, os.path.join(d, "grid.nc"))

    lat, lon = mesh.lat_cell, mesh.lon_cell
    f2 = (np.sin(np.deg2rad(lat)) * np.cos(np.deg2rad(lon))).astype(
        np.float32)
    f2v = (np.sin(np.deg2rad(mesh.lat_vertex))
           * np.cos(np.deg2rad(mesh.lon_vertex))).astype(np.float32)
    zlev = np.linspace(0.0, 1.0, NZ, dtype=np.float32)
    zlevp1 = np.linspace(0.0, 1.0, NZ + 1, dtype=np.float32)
    zsoil = np.linspace(0.0, 1.0, NSOIL, dtype=np.float32)

    def f3(levs, base=0.0, scale=1.0):
        return lambda: base + scale * (f2[:, None] + levs[None, :])

    diag2d = ["rainc", "rainnc", "snowncv", "rainncv", "graupelncv",
              "prec_acc_c", "prec_acc_nc", "snow_acc_nc", "refl10cm_max",
              "refl10cm_1km", "refl10cm_1km_max", "u10", "v10", "q2",
              "t2m", "th2m", "updraft_helicity_max", "w_velocity_max"]
    diag_fields = {name: 1.0 + (i + 1) * 0.1 * f2
                   for i, name in enumerate(diag2d)}
    diag_fields["refl10cm"] = f3(zlev, 20.0, 10.0)
    attrs = {"config_start_time": "2024-03-25_09:00:00", "config_dt": 60.0,
             "config_lsm_scheme": "noah",
             "config_microp_scheme": "mp_thompson",
             "config_convection_scheme": "cu_ntiedke"}
    t0 = time.perf_counter()
    write_mpas_data_file(mesh, os.path.join(d, "diag.nc"), diag_fields,
                         attrs=attrs, dtype="f4")
    print(f"- diag.nc written ({time.perf_counter() - t0:.0f}s)",
          flush=True)

    hist_fields = {
        "surface_pressure": 1.0e5 + 1000.0 * f2,
        "xland": np.where(lat > 0, 1.0, 2.0).astype(np.float32),
        "skintemp": 285.0 + 5.0 * f2,
        "snow": np.maximum(0.0, 100.0 * f2),
        "snowh": np.maximum(0.0, 1.0 * f2),
        "sst": 290.0 + 3.0 * f2,
        "zgrid": f3(zlevp1, 100.0, 1000.0),
        "w": f3(zlevp1, 0.0, 0.1),
        "theta": f3(zlev, 300.0, 10.0),
        "uReconstructZonal": f3(zlev, 15.0, 1.0),
        "uReconstructMeridional": f3(zlev, -5.0, 1.0),
        "qv": f3(zlev, 1e-3, 1e-3), "qc": f3(zlev, 0.0, 1e-4),
        "qr": f3(zlev, 0.0, 1e-4), "qi": f3(zlev, 0.0, 1e-4),
        "qs": f3(zlev, 0.0, 1e-4), "qg": f3(zlev, 0.0, 1e-4),
        "ni": f3(zlev, 0.0, 1e3), "nr": f3(zlev, 0.0, 1e3),
        "pressure": f3(zlev, 2e4, -1e4),
        "rho": f3(zlev, 1.0, 0.1),
        "vorticity": lambda: 1e-4 * (f2v[:, None] + zlev[None, :]),
        "tslb": f3(zsoil, 275.0, 1.0),
        "smois": f3(zsoil, 0.3, 0.1),
        "sh2o": f3(zsoil, 0.2, 0.1),
    }
    t0 = time.perf_counter()
    write_mpas_data_file(mesh, os.path.join(d, "hist.nc"), hist_fields,
                         attrs=attrs, dtype="f4")
    print(f"- hist.nc written ({time.perf_counter() - t0:.0f}s)",
          flush=True)

    # varlists: the reference's parm/ content verbatim + a vorticity line
    # (the vertex-located path, input_data.F90:843) for the full 973-col
    # load the headline sections measure
    vd = os.path.join(d, "parm")
    os.makedirs(vd, exist_ok=True)
    src_parm = os.path.join(REPO, "parm")
    for name in ("diaglist", "histlist_2d", "histlist_soil"):
        with open(os.path.join(src_parm, name)) as f:
            content = f.read()
        with open(os.path.join(vd, name), "w") as f:
            f.write(content)
    with open(os.path.join(src_parm, "histlist_3d")) as f:
        h3 = f.read()
    with open(os.path.join(vd, "histlist_3d"), "w") as f:
        f.write(h3.rstrip("\n") + "\nvorticity VORT\n")
    with open(stamp, "w") as f:
        f.write(tag)
    return d


def _make_config(d, cache_dir, out_file, stream):
    from mpassit_jax.config import Config

    cfg = Config.from_dict({
        "grid_file_input_grid": os.path.join(d, "grid.nc"),
        "diag_file_input_grid": os.path.join(d, "diag.nc"),
        "hist_file_input_grid": os.path.join(d, "hist.nc"),
        "output_file": out_file,
        "interp_diag": True, "interp_hist": True, "wrf_mod_vars": True,
        "target_grid_type": "lambert", "nx": NX + 1, "ny": NY + 1,
        "dx": 3000.0, "dy": 3000.0, "ref_lat": 38.5, "ref_lon": -97.5,
        "truelat1": 38.5, "stand_lon": -97.5,
    })
    cfg.varlist_dir = os.path.join(d, "parm")
    cfg.weights_cache_dir = cache_dir
    cfg.stream_output = stream
    return cfg


def _namelist_text(d, cache_dir, out_file, stream, **extra):
    """The production namelist; ``extra`` adds entries (values verbatim,
    e.g. apply_precision="'highest'")."""
    more = "".join(f" {k} = {v}\n" for k, v in extra.items())
    return f"""&config
 grid_file_input_grid = "{os.path.join(d, 'grid.nc')}"
 diag_file_input_grid = "{os.path.join(d, 'diag.nc')}"
 hist_file_input_grid = "{os.path.join(d, 'hist.nc')}"
 output_file = "{out_file}"
 interp_diag = .true.
 interp_hist = .true.
 wrf_mod_vars = .true.
 target_grid_type = 'lambert'
 nx = {NX + 1}
 ny = {NY + 1}
 dx = 3000.0
 dy = 3000.0
 ref_lat = 38.5
 ref_lon = -97.5
 truelat1 = 38.5
 stand_lon = -97.5
 varlist_dir = "{os.path.join(d, 'parm')}"
 weights_cache_dir = "{cache_dir}"
 stream_output = {'.true.' if stream else '.false.'}
{more}/
"""


_CHILD = """\
import json, resource, sys, time
t0 = time.time()
from mpassit_jax.config import Config
from mpassit_jax.run.pipeline import run_pipeline
import jax.numpy as jnp
cfg = Config.from_namelist(sys.argv[1])
art = run_pipeline(cfg, dtype=jnp.float32)
json.dump({
    "wall_s": round(time.time() - t0, 1),
    "stages": {k: round(v, 2) for k, v in art.timings.stages.items()},
    "maxrss_mb": round(resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e3, 1),
}, open(sys.argv[2], "w"))
"""


def _rss_runs(d, cache_dir, res, timeout=7200, keep_outputs=False):
    """Each writer's pipeline in its OWN subprocess (ru_maxrss = clean
    per-writer peak HOST memory; device buffers live in device memory).
    Runs are sequential: one JAX process per device."""
    import subprocess

    peak, wall, stages = {}, {}, {}
    for tag, stream in (("streamed", True), ("in_memory", False)):
        out_nc = os.path.join(d, f"rss_{tag}.nc")
        nml = os.path.join(d, f"namelist.rss_{tag}")
        side = os.path.join(d, f"rss_{tag}.json")
        if os.path.exists(side):
            os.unlink(side)
        with open(nml, "w") as f:
            f.write(_namelist_text(d, cache_dir, out_nc, stream))
        env = dict(os.environ,
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-c", _CHILD, nml, side],
                               env=env, capture_output=True, text=True,
                               timeout=timeout)
            if os.path.exists(side):
                with open(side) as f:
                    got = json.load(f)
                peak[tag] = got["maxrss_mb"]
                wall[tag] = got["wall_s"]
                stages[tag] = got["stages"]
            if r.returncode != 0:
                res.setdefault("rss_run_errors", {})[tag] = (
                    f"rc={r.returncode} " + r.stdout[-300:]
                    + r.stderr[-300:])
        except subprocess.TimeoutExpired:
            res.setdefault("rss_run_errors", {})[tag] = "timeout"
        finally:
            if os.path.exists(out_nc) and not keep_outputs:
                os.unlink(out_nc)
        print(f"- subprocess rss {tag}: {peak.get(tag)} MB, "
              f"{time.perf_counter() - t0:.0f}s", flush=True)
    if peak:
        res["peak_host_rss_mb_subprocess"] = peak
        res["subprocess_wall_s"] = wall
        res["subprocess_stages"] = stages
        res["rss_budget_mb"] = RSS_BUDGET_STREAMED_MB
        if "streamed" in peak and "in_memory" in peak:
            res["rss_budget_met"] = peak["streamed"] < RSS_BUDGET_STREAMED_MB
            res["rss_streamed_below_inmemory"] = (
                peak["streamed"] < peak["in_memory"])
    return res


def run_production(cache_dir):
    d = build_inputs(cache_dir)
    res = {
        "ncells": NCELLS, "nz": NZ, "nsoil": NSOIL,
        "grid": f"{NX}x{NY} lambert 3km CONUS",
        "n_cols": 18 + NZ + 3 + 2 + 1 + 11 * NZ + 2 * (NZ + 1) + NZ
        + 2 * NZ + 3 * NSOIL,
        "varlists": "parm/ defaults + vorticity (vertex path)",
        "input_gb": round(sum(
            os.path.getsize(os.path.join(d, f))
            for f in ("grid.nc", "hist.nc", "diag.nc")) / 1e9, 2),
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "measurement": "each run in its own subprocess (process-cold, "
                       "disk caches warm — the production cadence: one "
                       "process per forecast hour), sequential",
    }
    # the two subprocess runs are THE measurement: wall + stages +
    # ru_maxrss per writer, outputs kept for the equality check
    _rss_runs(d, cache_dir, res, keep_outputs=True)
    wall = res.get("subprocess_wall_s", {})
    if "streamed" in wall:
        res["t_pipeline_streamed_s"] = wall["streamed"]
    if "in_memory" in wall:
        res["t_pipeline_inmem_s"] = wall["in_memory"]
    out_s = os.path.join(d, "rss_streamed.nc")
    out_m = os.path.join(d, "rss_in_memory.nc")
    if os.path.exists(out_s):
        res["output_gb"] = round(os.path.getsize(out_s) / 1e9, 2)
    if os.path.exists(out_s) and os.path.exists(out_m):
        from mpassit_jax.io.nc4 import open_dataset

        with open_dataset(out_s) as a, open_dataset(out_m) as b:
            names = a.var_names()
            ok = names == b.var_names()
            for name in names:
                x, y = np.asarray(a.read_var(name)), np.asarray(
                    b.read_var(name))
                if not (np.array_equal(x, y, equal_nan=True)
                        if x.dtype.kind == "f" else np.array_equal(x, y)):
                    ok = False
                    res.setdefault("writer_mismatch", []).append(name)
            res["streamed_equals_inmemory_file"] = ok
        print(f"- files identical: {res['streamed_equals_inmemory_file']}",
              flush=True)
        for f in (out_s, out_m):
            os.unlink(f)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cache_dir = os.environ.get(
        "BENCH_CACHE", os.path.join(REPO, ".bench_cache"))
    out = os.path.join(REPO, "chiprun_out", "production_e2e.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if "--rss-only" in argv:
        # re-run the subprocess measurements into an existing artifact
        # (the parent stays off the device: runs happen in children,
        # sequential), refreshing walls and the file-equality check
        with open(out) as f:
            res = json.load(f)
        d = build_inputs(cache_dir)
        _rss_runs(d, cache_dir, res, keep_outputs=True)
        wall = res.get("subprocess_wall_s", {})
        if "streamed" in wall:
            res["t_pipeline_streamed_s"] = wall["streamed"]
        if "in_memory" in wall:
            res["t_pipeline_inmem_s"] = wall["in_memory"]
        out_s = os.path.join(d, "rss_streamed.nc")
        out_m = os.path.join(d, "rss_in_memory.nc")
        if os.path.exists(out_s) and os.path.exists(out_m):
            from mpassit_jax.io.nc4 import open_dataset

            with open_dataset(out_s) as a, open_dataset(out_m) as b:
                ok = a.var_names() == b.var_names()
                for name in a.var_names():
                    x = np.asarray(a.read_var(name))
                    y = np.asarray(b.read_var(name))
                    if not (np.array_equal(x, y, equal_nan=True)
                            if x.dtype.kind == "f"
                            else np.array_equal(x, y)):
                        ok = False
                        res.setdefault("writer_mismatch", []).append(name)
                res["streamed_equals_inmemory_file"] = ok
            res["output_gb"] = round(os.path.getsize(out_s) / 1e9, 2)
            print(f"- files identical: {ok}", flush=True)
            for fpath in (out_s, out_m):
                os.unlink(fpath)
        res.pop("writer_mismatch", None) if res.get(
            "streamed_equals_inmemory_file") else None
    else:
        res = run_production(cache_dir)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    print(f"- written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
