"""Apply benchmark on one NVIDIA GPU: the pipeline's packed apply at the
production envelope (1801x1061 3-km CONUS target, 2.6M-cell source,
973 columns), against the plain gather apply and a device copy.

Prints the full result as one JSON line, then a compact summary as the
last line (see emit_results). Exits non-zero when JAX finds no GPU: no
number here is ever taken on another device.

Sections:

- ``apply_ab``: in one process, timed with ``block_until_ready`` (median
  of BENCH_REPS calls after a compile/warm call):
  (a) ``PackedSlabRegridder`` exactly as the pipeline runs it on the
      device (slab gather, tile matmuls, ``_unblock``, ``_rotate_post``
      of the wind window; apply_precision split6_bf16, the default);
  (b) ``ops.apply.apply_ell`` over each method's operator, writing the
      same packed columns to one row-major (ny, nx, C) array, rotation
      included;
  (c) a device-to-device copy of an output-sized buffer (x + 1: one read
      and one write per element).
  Each reports GB/s of output bytes and its share of the copy's rate.
- ``vs_baseline``: (a) against a NumPy f64 apply of the same operator on
  the host (subset-scaled), the stand-in for the reference's CPU apply
  (the reference publishes no numbers).
- ``e2e`` (BENCH_E2E=1): run_pipeline wall clock at a reduced config.

Environment knobs: BENCH_NCELLS, BENCH_NX, BENCH_NY, BENCH_NZ,
BENCH_REPS, BENCH_CACHE, BENCH_E2E.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def getenv_int(name, default):
    return int(os.environ.get(name, default))


def _time_once(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def require_gpu():
    """Device record for the result; exits when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX reports {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi[0] if smi else None}


def time_device(fn, args, reps):
    """(median seconds over ``reps`` calls, first-call seconds) of a
    device computation, each call ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t_first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), t_first


def apply_ab(grid, ells, cols, nz, reps, cache_dir):
    """The apply A/B (module docstring): packed slab-matmul path vs the
    plain gather apply vs a copy, all at the same output shape."""
    import jax
    import jax.numpy as jnp

    from mpassit_jax.ops.apply import apply_ell
    from mpassit_jax.ops.matmul_apply import PackedSlabRegridder
    from mpassit_jax.ops.rotate import rotate_winds

    ny, nx = grid.shape
    C = sum(cols)
    # the winds lead the bilinear range, as run_pipeline packs them
    windows = ((0, nz, nz),)
    pk = PackedSlabRegridder(
        list(zip(ells, cols)), precision="split6_bf16",
        rotate_spec=(windows, grid.cosa, grid.sina), cache_dir=cache_dir)
    rng = np.random.default_rng(0)
    src = rng.standard_normal((ells[0].n_src, pk.Cp)).astype(np.float32)
    src[:, C:] = 0.0
    src_d = jnp.asarray(src)
    del src

    # (a) the pipeline's device apply: what apply_np runs before fetching
    _ = pk.As
    t_a, t_a0 = time_device(
        lambda s: pk._apply_group(s, 0, pk.rotate), (src_d,), reps)

    # (b) apply_ell per method into one row-major packed output
    ops = [(jnp.asarray(e.idx, jnp.int32), jnp.asarray(e.w, jnp.float32))
           for e in ells]
    cosa = jnp.asarray(grid.cosa, jnp.float32)
    sina = jnp.asarray(grid.sina, jnp.float32)

    @jax.jit
    def plain(src, ops, cosa, sina):
        outs, off = [], 0
        for (idx, w), c in zip(ops, cols):
            outs.append(apply_ell(idx, w, src[:, off:off + c]))
            off += c
        out = jnp.concatenate(outs, axis=1).reshape(ny, nx, C)
        u, v = rotate_winds(out[:, :, :nz], out[:, :, nz:2 * nz], cosa,
                            sina)
        return jnp.concatenate([u, v, out[:, :, 2 * nz:]], axis=2)

    t_b, t_b0 = time_device(plain, (src_d, ops, cosa, sina), reps)
    del src_d

    # (c) copy of an output-sized buffer
    out_bytes = ny * nx * C * 4
    buf = jnp.zeros((ny, nx, C), jnp.float32)
    t_c, _ = time_device(jax.jit(lambda x: x + 1.0), (buf,), reps)
    del buf

    gb = out_bytes / 1e9
    return {
        "output_gb": round(gb, 4), "n_cols": C, "lane_padded_cols": pk.Cp,
        "slab_width_W": pk.W, "reps": reps,
        "t_packed_xla_s": t_a, "t_apply_ell_s": t_b, "t_copy_s": t_c,
        "t_first_packed_xla_s": round(t_a0, 2),
        "t_first_apply_ell_s": round(t_b0, 2),
        "gbps_packed_xla": gb / t_a, "gbps_apply_ell": gb / t_b,
        "gbps_copy": gb / t_c,
        "pct_copy_packed_xla": 100.0 * t_c / t_a,
        "pct_copy_apply_ell": 100.0 * t_c / t_b,
        "note": "GB/s of output bytes (ny*nx*n_cols*4); pct_copy = share "
                "of the x+1 copy's rate at the same output shape",
    }


def _cached_mesh(cache_dir, ncells, nz, nsoil, seed=1):
    """Synthetic mesh memoized to disk — SphericalVoronoi at 2.6M cells is
    ~80 s of host time; repeat bench runs load the arrays instead."""
    from mpassit_jax.mesh.mpas import MPASMesh
    from mpassit_jax.mesh.synthetic import synthetic_voronoi_mesh

    path = os.path.join(cache_dir, f"mesh_{ncells}_{nz}_{nsoil}_{seed}.npz")
    if cache_dir and os.path.exists(path):
        z = np.load(path)
        return MPASMesh(
            ncells=int(z["ncells"]), nvertices=int(z["nvertices"]),
            nz=nz, nzp1=nz + 1, max_edges=int(z["max_edges"]), nsoil=nsoil,
            lat_cell=z["lat_cell"], lon_cell=z["lon_cell"],
            lat_vertex=z["lat_vertex"], lon_vertex=z["lon_vertex"],
            vertices_on_cell=z["voc"], cells_on_vertex=z["cov"],
            ter=z["ter"], zs=z["zs"])
    mesh = synthetic_voronoi_mesh(ncells=ncells, nz=nz, nsoil=nsoil,
                                  seed=seed)
    if cache_dir:
        tmp = path + ".tmp.npz"
        np.savez(tmp, ncells=mesh.ncells, nvertices=mesh.nvertices,
                 max_edges=mesh.max_edges, lat_cell=mesh.lat_cell,
                 lon_cell=mesh.lon_cell, lat_vertex=mesh.lat_vertex,
                 lon_vertex=mesh.lon_vertex, voc=mesh.vertices_on_cell,
                 cov=mesh.cells_on_vertex, ter=mesh.ter, zs=mesh.zs)
        os.replace(tmp, path)
    return mesh


def build_conus_problem(ncells, nx, ny, nz, nsoil, cache):
    from mpassit_jax.config import Config
    from mpassit_jax.grids.target import build_target_grid
    from mpassit_jax.weights.bilinear import bilinear_cell_weights
    from mpassit_jax.weights.cache import grid_fingerprint
    from mpassit_jax.weights.conservative import conservative_weights
    from mpassit_jax.weights.nearest import nearest_weights

    cfg = Config.from_dict({
        "target_grid_type": "lambert", "nx": nx + 1, "ny": ny + 1,
        "dx": 3000.0 * (1801 / nx), "dy": 3000.0 * (1801 / nx),
        "ref_lat": 38.5, "ref_lon": -97.5, "truelat1": 38.5,
        "stand_lon": -97.5,
    })
    cfg.weights_cache_dir = cache.dir   # grid + pack caches ride along
    grid = build_target_grid(cfg)
    mesh = _cached_mesh(cache.dir, ncells, nz, nsoil)
    # production parity: run_pipeline renumbers source cells along a
    # target-space Z-curve by default (cell_order='morton'), which makes
    # each tile's slab gather read a compact span of device memory — the
    # bench measures the same numbering (BENCH_MORTON=0 for file order)
    if os.environ.get("BENCH_MORTON") != "0":
        from mpassit_jax.mesh.reorder import reorder_cells_morton

        mesh = reorder_cells_morton(mesh, grid.proj).mesh
    fpm, fpg = mesh.fingerprint(), grid_fingerprint(grid)
    # label the reported times honestly: a warm run loads .npz weight
    # files instead of generating (the RegridStore-cache win itself)
    warm = all(cache.has(t, fpm, fpg)
               for t in ("bilinear", "nearest", "conserve"))
    times = {"cache": "warm" if warm else "cold"}
    t0 = time.perf_counter()
    ell_b = cache.get_or_build(
        "bilinear", fpm, fpg,
        lambda: bilinear_cell_weights(mesh, grid.lat, grid.lon))
    times["bilinear"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    ell_n = cache.get_or_build(
        "nearest", fpm, fpg, lambda: nearest_weights(mesh, grid.lat, grid.lon))
    times["nearest"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    ell_c = cache.get_or_build(
        "conserve", fpm, fpg, lambda: conservative_weights(mesh, grid))
    times["conserve"] = round(time.perf_counter() - t0, 2)
    return cfg, grid, mesh, (ell_b, ell_n, ell_c), times



def main() -> int:
    dev = require_gpu()
    ncells = getenv_int("BENCH_NCELLS", 2_600_000)
    nx = getenv_int("BENCH_NX", 1801)
    ny = getenv_int("BENCH_NY", 1061)
    nz = getenv_int("BENCH_NZ", 55)
    nsoil = 4
    reps = getenv_int("BENCH_REPS", 10)

    from mpassit_jax.compilecache import enable_compile_cache
    from mpassit_jax.weights.cache import WeightCache

    cache_dir = os.environ.get(
        "BENCH_CACHE", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), ".bench_cache"))
    cache = WeightCache(cache_dir)
    enable_compile_cache()

    t0 = time.perf_counter()
    cfg, grid, mesh, (ell_b, ell_n, ell_c), t_weights = build_conus_problem(
        ncells, nx, ny, nz, nsoil, cache)
    t_setup = time.perf_counter() - t0

    # the default variable load (parm/ lists + vorticity): diag 18 2-D +
    # 1 3-D(nz); hist 2d: 3 patch + 2 cons + 1 nstd; hist 3d: 11 nz +
    # 2 nzp1 + u + v; vorticity (vertex operator, bilinear-class cost);
    # soil 3 x nsoil rides the nearest operator (quirk Q3)
    cols_bilinear = 18 + nz + 3 + 11 * nz + 2 * (nz + 1) + 2 * nz + nz
    cols_nstd = 1 + 3 * nsoil
    cols_cons = 2
    cols = (cols_bilinear, cols_nstd, cols_cons)
    ab = apply_ab(grid, (ell_b, ell_n, ell_c), cols, nz, reps, cache_dir)

    # NumPy f64 apply of the bilinear operator on a row subset, scaled
    T = nx * ny
    sub = min(T, 200_000)
    rng = np.random.default_rng(1)
    srcf = rng.standard_normal((mesh.ncells, 64))
    idx_s, w_s = ell_b.idx[:sub], ell_b.w[:sub]
    t_np = min(_time_once(lambda: (w_s[:, :, None] * srcf[idx_s])
                          .sum(axis=1)) for _ in range(3)) * (T / sub)
    np_rate = T * 64 / t_np
    value = T * sum(cols) / ab["t_packed_xla_s"]

    result = {
        "metric": "point-values/s of the pipeline's packed apply on the "
                  f"device ({nx}x{ny} CONUS, {sum(cols)} cols, "
                  f"{ncells} source cells)",
        "value": round(value, 1),
        "unit": "point-values/s",
        "vs_baseline": round(value / np_rate, 2),
        "device": dev,
        "value_apply_ell": round(T * sum(cols) / ab["t_apply_ell_s"], 1),
        "pct_copy_packed_xla": round(ab["pct_copy_packed_xla"], 1),
        "pct_copy_apply_ell": round(ab["pct_copy_apply_ell"], 1),
        "apply_ab": ab,
        "t_weightgen_s": t_weights,
        "t_setup_s": round(t_setup, 2),
        "host_cpus": os.cpu_count(),
        "ncells": ncells, "nz": nz,
    }
    if os.environ.get("BENCH_E2E", "0") != "0":
        result["e2e"] = bench_e2e(cache_dir)
    emit_results(result)
    return 0


def _compact_summary(result):
    """Headline-first summary that MUST fit a 2000-char stdout tail
    capture (a single full-detail JSON line can outgrow that window and be
    truncated mid-line). Printed LAST; full detail precedes it and lands
    in BENCH_DETAIL.json. Top-level numbers (value_*, t_*, pct_*) are
    kept; sections keep their headline keys."""
    s = {k: result.get(k) for k in ("metric", "value", "unit",
                                    "vs_baseline", "device")}
    s.update({k: v for k, v in result.items()
              if k.startswith(("value_", "t_", "pct_"))
              and isinstance(v, (int, float))})
    s["detail"] = "full sections in BENCH_DETAIL.json (this directory)"
    ab = result.get("apply_ab")
    if ab:
        s["apply_ab"] = {k: ab.get(k) for k in (
            "gbps_packed_xla", "gbps_apply_ell", "gbps_copy",
            "pct_copy_packed_xla", "pct_copy_apply_ell", "output_gb")}
    fm = result.get("full_mesh")
    if fm:
        s["full_mesh"] = {
            k: fm.get(k) for k in (
                "ncells", "backend", "n_cols", "t_apply_pass_s",
                "value_materialized", "value_write_wall",
                "pct_of_write_wall", "t_compile_cold_s",
                "t_compile_warm_s", "bytes_per_pass_total_gb")}
    e2e = result.get("e2e")
    if e2e:
        s["e2e"] = {k: e2e.get(k) for k in (
            "t_pipeline_warm_s", "t_pipeline_warm_streamed_s",
            "peak_host_rss_mb_subprocess", "output_mb")}
    prod = result.get("e2e_production")
    if prod:
        s["e2e_production"] = {k: prod.get(k) for k in (
            "ncells", "grid", "n_cols", "output_gb",
            "t_pipeline_streamed_s", "t_pipeline_inmem_s",
            "peak_host_rss_mb_subprocess", "rss_budget_mb",
            "rss_budget_met", "streamed_equals_inmemory_file")}
    line = json.dumps(s)
    # hard cap with graceful degradation: drop optional blocks until the
    # line fits the capture window with margin
    for drop in ("e2e", "detail", "full_mesh", "e2e_production",
                 "apply_ab"):
        if len(line) <= 1800:
            break
        s.pop(drop, None)
        line = json.dumps(s)
    return line


def emit_results(result):
    detail = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "BENCH_DETAIL.json")
    try:
        with open(detail, "w") as f:
            json.dump(result, f, indent=1)
    except OSError:
        pass
    print(json.dumps(result))
    # whitespace spacer: when only the final ~2000 chars of stdout are
    # kept, the spacer guarantees that window holds only (JSON-legal)
    # whitespace plus the compact line, so it parses whether a reader
    # loads the whole tail or just the last line
    print(" " * 2200)
    print(_compact_summary(result))


def _rss_window():
    """Sample this process's RSS on a 20 ms poll until stopped; returns
    (stop_fn -> peak_bytes)."""
    import threading

    stop = threading.Event()
    peak = [0]

    def poll():
        while True:
            try:
                with open("/proc/self/statm") as f:
                    peak[0] = max(peak[0],
                                  int(f.read().split()[1]) * 4096)
            except OSError:
                pass
            if stop.wait(0.02):
                return

    t = threading.Thread(target=poll, daemon=True)
    t.start()

    def done():
        stop.set()
        t.join()
        return peak[0]

    return done


def bench_e2e(cache_dir):
    """Full run_pipeline wall-clock (weights cached) including the NetCDF
    write, at a reduced-column CONUS config (nz=8), reported separately
    from the headline. Runs the warm pipeline through BOTH writers: the
    in-memory path and the streamed path (stream_output=.true.), with peak
    host RSS sampled over each and the streamed run's fetch/write overlap
    reported. In-process: the pipeline shares this process's device."""
    import tempfile

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from test_pipeline import make_case

    from mpassit_jax.run.pipeline import run_pipeline

    d = tempfile.mkdtemp(prefix="mpassit_e2e_")
    from pathlib import Path

    mesh, cfg, _, _ = make_case(
        Path(d), ncells=getenv_int("BENCH_E2E_NCELLS", 150_000),
        nz=getenv_int("BENCH_E2E_NZ", 8), nsoil=4,
        nx=getenv_int("BENCH_E2E_NX", 601),
        ny=getenv_int("BENCH_E2E_NY", 355), dx=9000.0)
    cfg.weights_cache_dir = cache_dir
    t0 = time.perf_counter()
    art = run_pipeline(cfg, dtype=jnp.float32)
    t_cold = time.perf_counter() - t0
    rss_done = _rss_window()
    t0 = time.perf_counter()
    art = run_pipeline(cfg, dtype=jnp.float32)
    t_warm = time.perf_counter() - t0
    rss_mem = rss_done()
    out_bytes = os.path.getsize(cfg.output_file)

    # streamed run: strips go straight to the file via the writer thread
    cfg.stream_output = True
    cfg.output_file = os.path.join(d, "out_stream.nc")
    run_pipeline(cfg, dtype=jnp.float32)   # compile any stream-only shapes
    rss_done = _rss_window()
    t0 = time.perf_counter()
    art_s = run_pipeline(cfg, dtype=jnp.float32)
    t_stream = time.perf_counter() - t0
    rss_stream = rss_done()
    st = art_s.timings.stages
    # blocking wait on the writer thread at finish (the schema-creation
    # open is real write_to_file time but not hideable by overlap)
    write_block = st.get("stream_finish_wait_s",
                         st.get("write_to_file", 0.0))
    write_thread = st.get("stream_write_s", 0.0)  # in-thread file writes
    overlap = (max(0.0, 1.0 - write_block / write_thread)
               if write_thread > 0 else 0.0)
    res = {
        "t_pipeline_cold_s": round(t_cold, 2),
        "t_pipeline_warm_s": round(t_warm, 2),
        "t_pipeline_warm_streamed_s": round(t_stream, 2),
        "stages_warm": {k: round(v, 3) for k, v in art.timings.stages.items()},
        "stages_warm_streamed": {k: round(v, 3) for k, v in st.items()},
        # in-process peaks include earlier bench sections (the allocator
        # retains their arrays); tools/bench_production.py measures clean
        # per-writer subprocess peaks
        "peak_host_rss_mb_inprocess": {
            "in_memory": round(rss_mem / 1e6, 1),
            "streamed": round(rss_stream / 1e6, 1)},
        # fraction of the file write time hidden under the device fetch
        "stream_write_overlap": round(overlap, 3),
        "stream_write_thread_s": round(write_thread, 2),
        "output_mb": round(out_bytes / 1e6, 1),
    }
    return res


if __name__ == "__main__":
    sys.exit(main())
