"""End-to-end batch pipeline (the reference's ``program mpassit``).

Sequence mirrors mpassit.F90:105-137: read namelist -> build target grid ->
ingest MPAS mesh -> read fields -> generate/cache weights -> apply on device
-> wind fixups -> write WRF-compatible NetCDF.

Method routing reproduces interp.F90:

- diag bundle, 2d patch bundle, hgt, 3d nz bundle, u/v first hop, 3d nzp1
  bundle, 3d vert bundle: BILINEAR (quirks Q1/Q2 — "patch" is bilinear and
  the hgt/3d `method` carryover is bilinear for any nonempty default list);
- 2d cons bundle: CONSERVE;
- 2d nstd bundle: NEAREST_STOD;
- soil bundle: the `method` carryover quirk Q3 (Routing.soil_method);
- u/v: mesh -> mass points, rotate to grid-relative (LC only, quirk Q4),
  then mass -> EDGE1/EDGE2 restagger (quirk Q6). The outermost staggered
  columns/rows fall outside the mass grid and are unmapped (zeros) —
  matching unmappedaction=IGNORE on the reference's center->edge regrid.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..constants import PROJ_LC
from ..fields.registry import Routing, build_routing
from ..grids.target import TargetGrid, build_target_grid
from ..io.mpas_reader import InputData, read_diag_data, read_hist_data
from ..io.wrf_writer import RegridResult, write_output
from ..mesh.mpas import MPASMesh, mesh_from_file
from ..ops.apply import Regridder
from ..ops.rotate import rotate_winds
from ..weights.bilinear import bilinear_cell_weights, bilinear_vertex_weights
from ..weights.cache import WeightCache, grid_fingerprint
from ..weights.conservative import conservative_weights
from ..weights.ell import ELLWeights
from ..weights.nearest import nearest_weights
from ..weights.restagger import edge1_weights, edge2_weights

log = logging.getLogger("mpassit_jax")


@dataclasses.dataclass
class Timings:
    stages: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, dt: float):
        self.stages[name] = self.stages.get(name, 0.0) + dt


class _Timer:
    def __init__(self, timings: Timings, name: str):
        self.t, self.name = timings, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *a):
        self.t.add(self.name, time.perf_counter() - self.t0)
        log.info("- %s: %.3fs", self.name, self.t.stages[self.name])


def _nan_guard(name: str, arr) -> None:
    """MPASSIT_DEBUG_NANS=1: per-field invalid-value trap (the reference's
    -ffpe-trap debug-build analog, CMakeLists.txt:36)."""
    if os.environ.get("MPASSIT_DEBUG_NANS") == "1" and not np.isfinite(
            arr).all():
        from ..errors import FatalError

        raise FatalError(f"NON-FINITE VALUES IN REGRIDDED FIELD {name}")


def _unstack_specs(out, data: InputData, specs, nlevs):
    """Slice an applied (ny, nx, C) block back into per-field tuples."""
    res, off = [], 0
    for s, nl in zip(specs, nlevs):
        arr = out[..., off] if nl is None else out[..., off:off + nl]
        res.append((s.out_name, arr, data.units[s.in_name],
                    data.long_name[s.in_name]))
        off += 1 if nl is None else nl
    for name, arr, *_ in res:
        _nan_guard(name, arr)
    return res


class _StripRouter:
    """Maps an apply's fetched column strips to their consumers: variables
    stream straight into the output file (StreamingWriter.put), parts that
    must stay in memory (mass winds for the restagger, deferred-rotation
    diag winds) fill small host buffers. Peak host memory of a streamed
    apply = one strip + the buffered parts."""

    def __init__(self, writer, dst_shape):
        self.writer = writer
        self.dst_shape = dst_shape
        self.segs = []       # (c0, c1, var, lev0) streamed segments
        self.bufs = []       # (c0, c1, array, squeeze, sink)
        self.off = 0

    def add_stream(self, entries, defer=(), deferred=None):
        """entries: [(var, nlev_or_None)], consecutive columns. Vars in
        ``defer`` are buffered into ``deferred[var]`` instead of streamed
        (e.g. U10/V10 awaiting the post-apply Q4 rotation)."""
        for var, nlev in entries:
            k = 1 if nlev is None else nlev
            if var in defer:
                buf = np.empty(self.dst_shape + (k,), np.float32)
                deferred[var] = (buf, nlev)
                self.bufs.append((self.off, self.off + k, buf, False, None))
            else:
                self.segs.append((self.off, self.off + k, var, nlev))
            self.off += k

    def add_buffer(self, ncols, squeeze, sink):
        buf = np.empty(self.dst_shape + (ncols,), np.float32)
        self.bufs.append((self.off, self.off + ncols, buf, squeeze, sink))
        self.off += ncols

    def __call__(self, lo, strip):
        hi = lo + strip.shape[2]
        for c0, c1, var, nlev in self.segs:
            a, b = max(c0, lo), min(c1, hi)
            if a < b:
                blk = strip[:, :, a - lo:b - lo]
                if nlev is None:
                    blk = blk[:, :, 0]
                _nan_guard(var, blk)
                self.writer.put(var, a - c0, blk)
        for c0, c1, buf, _, _ in self.bufs:
            a, b = max(c0, lo), min(c1, hi)
            if a < b:
                buf[:, :, a - c0:b - c0] = strip[:, :, a - lo:b - lo]

    def finalize(self):
        for _, _, buf, squeeze, sink in self.bufs:
            if sink is not None:
                sink(buf[:, :, 0] if squeeze else buf)


class _ApplyBatch:
    """Cross-category bundle packing: every stack routed to the SAME weight
    operator joins one (n_src, C_total) apply.

    The reference amortizes one route handle per FieldBundle
    (interp.F90:123-136) but still pays one distributed SMM per bundle;
    here all same-method bundles share a single slab gather and apply,
    and — with LANE(128) column padding — narrow stacks (a 1-col hgt, a
    2-col conservative pair) no longer each pay a full padded-width
    output. Sinks run after the one apply, in add() order.

    With a ``writer`` (StreamingWriter), parts carrying ``stream`` entries
    write their fetched strips directly into the output file and their
    sinks are skipped; other parts buffer (see _StripRouter)."""

    def __init__(self, rg, dtype, root_only: bool = False):
        self.rg, self.dtype = rg, dtype
        self.root_only = root_only
        self.parts = []   # (n_cols, src_matrix, squeeze, sink, tag, stream)

    def add(self, src, sink, tag=None, stream=None):
        """src (n_src,) or (n_src, k) — or a LIST of such per-field blocks
        (never concatenated on host: at the production load a category
        stack is ~7 GB, and the block-list engines upload blocks
        individually); sink receives the (ny, nx, k) block (or (ny, nx)
        when src was 1-D). ``tag`` marks parts for special treatment by
        the packed apply (e.g. "rot_u"/"rot_v" wind columns rotated
        inside the apply); ``stream`` = [(var, nlev)] routes the part's columns
        straight to the output file in streaming mode."""
        if isinstance(src, list):
            n = sum(1 if b.ndim == 1 else b.shape[1] for b in src)
            self.parts.append((n, src, False, sink, tag, stream))
            return
        squeeze = src.ndim == 1
        mat = src[:, None] if squeeze else src
        self.parts.append((mat.shape[1], mat, squeeze, sink, tag, stream))

    def add_stack(self, data: InputData, specs, ndim: int, sink):
        """Pack a varlist category; sink receives [(name, arr, units,
        long_name)] in spec order."""
        if not specs:
            sink([])
            return
        if ndim == 2:
            nlevs = [None] * len(specs)
        else:
            nlevs = [data.fields[s.in_name].shape[1] for s in specs]
        self.add([data.fields[s.in_name] for s in specs], lambda out: sink(
            _unstack_specs(out, data, specs, nlevs)),
            stream=[(s.out_name, nl) for s, nl in zip(specs, nlevs)])

    #: vars buffered for post-apply handling in streaming mode (set by the
    #: pipeline: U10/V10 awaiting rotation); results land in ``deferred``
    defer: frozenset = frozenset()

    def _make_router(self, writer, deferred=None):
        router = _StripRouter(writer, self.rg.dst_shape)
        for k, _, squeeze, sink, _, stream in self.parts:
            if stream is not None:
                router.add_stream(stream, defer=self.defer,
                                  deferred=deferred)
            else:
                router.add_buffer(k, squeeze, sink)
        return router

    def run(self, writer=None, deferred=None):
        if not self.parts:
            return
        src = []
        for _, m, _, _, _, _ in self.parts:
            src.extend(m if isinstance(m, list) else [m])
        if not getattr(self.rg, "accepts_blocks", False):
            # gather engines take one host matrix
            src = np.concatenate(
                [b[:, None] if b.ndim == 1 else b for b in src],
                axis=1).astype(self.dtype)
        if writer is None:
            out = self.rg.apply_np(src, root_only=self.root_only)
            off = 0
            for k, _, squeeze, sink, _, _ in self.parts:
                sink(out[..., off] if squeeze else out[..., off:off + k])
                off += k
        else:
            router = self._make_router(writer, deferred=deferred)
            if getattr(self.rg, "accepts_blocks", False):
                self.rg.apply_np(src, root_only=self.root_only,
                                 strip_sink=router)
            else:
                # gather engines can't stream strips: materialize, then
                # route the whole block once
                out = self.rg.apply_np(src, root_only=self.root_only)
                router(0, out)
            router.finalize()
        self.parts = []


def _run_batches_packed(batches, rgs, weights, np_dtype, root_only,
                        grid=None, writer=None, deferred=None) -> bool:
    """Cross-METHOD packing: when the cell-space methods (bilinear /
    nearest / conserve) all ride SlabMatmulRegridder engines, fuse their
    batches into ONE PackedSlabRegridder apply — one union-slab gather and
    one LANE-padded output for every cell-located field in the run (see
    ops/matmul_apply.PackedSlabRegridder). Drained batches are emptied;
    anything unpacked (vertex space, f64 engines, sharded-source engines)
    runs normally afterwards. MPASSIT_NO_PACK=1 disables (test hook).

    Parts tagged "rot_u"/"rot_v" (the mass winds under Lambert) are moved
    to the FRONT of the bilinear column range and the Q4 earth->grid
    rotation runs INSIDE the apply — their
    sinks receive already-rotated winds and no separate rotate pass (with
    its device round-trip) is needed. Returns True when that in-apply
    rotation was performed."""
    if os.environ.get("MPASSIT_NO_PACK") == "1":
        return False
    from ..ops.matmul_apply import PackedSlabRegridder, SlabMatmulRegridder

    cell_keys = [k for k in ("bilinear", "nearest", "conserve")
                 if k in batches and batches[k].parts]
    if len(cell_keys) < 2 or not all(
            isinstance(rgs[k], SlabMatmulRegridder) for k in cell_keys):
        return False

    # in-apply wind rotation: pull the tagged u/v parts to the head of the
    # bilinear range so their windows ride the first column group
    rotate_spec = None
    if grid is not None and "bilinear" in cell_keys:
        bparts = batches["bilinear"].parts
        tagged = {p[4]: i for i, p in enumerate(bparts)
                  if p[4] in ("rot_u", "rot_v")}
        if set(tagged) == {"rot_u", "rot_v"}:
            iu, iv = tagged["rot_u"], tagged["rot_v"]
            n_u, n_v = bparts[iu][0], bparts[iv][0]
            if n_u == n_v:
                rest = [p for i, p in enumerate(bparts) if i not in (iu, iv)]
                batches["bilinear"].parts = [bparts[iu], bparts[iv]] + rest
                rotate_spec = (((0, n_u, n_u),), grid.cosa, grid.sina)
    ref_rg = rgs[cell_keys[0]]
    ells_and_cols = [(weights[k], sum(p[0] for p in batches[k].parts))
                     for k in cell_keys]
    cache_dir = getattr(ref_rg, "cache_dir", None)
    try:
        pk = PackedSlabRegridder(
            ells_and_cols, precision=ref_rg.precision, mesh=ref_rg.mesh,
            rotate_spec=rotate_spec, cache_dir=cache_dir)
    except ValueError:
        return False             # e.g. union exceeds the W cap
    # list of per-part column blocks: assembled ON DEVICE (_src_to_device),
    # never concatenated on host (item 3: ~10 GB saved at production load);
    # stack parts carry per-field block lists — flatten them
    src = []
    for k in cell_keys:
        for _, m, _, _, _, _ in batches[k].parts:
            src.extend(m if isinstance(m, list) else [m])
    log.info("- packed apply: %s (%d cols, one pass%s%s)",
             "+".join(cell_keys), pk.C_total,
             ", in-apply wind rotation" if rotate_spec else "",
             ", streamed to file" if writer is not None else "")
    if writer is not None:
        router = _StripRouter(writer, pk.dst_shape)
        for k in cell_keys:
            b = batches[k]
            for kcols, _, squeeze, sink, _, stream in b.parts:
                if stream is not None:
                    router.add_stream(stream, defer=b.defer,
                                      deferred=deferred)
                else:
                    router.add_buffer(kcols, squeeze, sink)
        pk.apply_np(src, root_only=root_only, strip_sink=router)
        router.finalize()
        for k in cell_keys:
            batches[k].parts = []
        return rotate_spec is not None
    out = pk.apply_np(src, root_only=root_only)
    off = 0
    for k in cell_keys:
        b = batches[k]
        for kcols, _, squeeze, sink, _, _ in b.parts:
            sink(out[..., off] if squeeze else out[..., off:off + kcols])
            off += kcols
        b.parts = []
    return rotate_spec is not None


def _build_stream_plan(cfg, routing, data) -> dict:
    """Per-category (out_name, units, desc) lists for StreamingWriter —
    the same schema the in-memory path derives from RegridResult, known
    before any apply runs."""
    def ent(specs):
        return [(s.out_name, data.units[s.in_name],
                 data.long_name[s.in_name]) for s in specs]

    plan = {}
    if cfg.interp_diag:
        plan["diag2d"] = ent(
            [s for s in routing.diag if data.fields[s.in_name].ndim == 1])
        plan["diag3d"] = ent(
            [s for s in routing.diag if data.fields[s.in_name].ndim == 2])
    if cfg.interp_hist:
        plan["patch2d"] = ent(routing.patch_2d)
        plan["cons2d"] = ent(routing.cons_2d)
        plan["nstd2d"] = ent(routing.nstd_2d)
        plan["soil"] = ent(routing.soil)
        plan["nz3d"] = ent(routing.nz_3d)
        plan["nzp13d"] = ent(routing.nzp1_3d)
        plan["vert3d"] = ent(routing.vert_3d)
        plan["do_u"] = routing.do_u
        plan["do_v"] = routing.do_v
    return plan


def _stack_apply(rg: Regridder, data: InputData, specs, ndim: int,
                 dtype=np.float32, root_only: bool = False):
    """One-shot bundle apply (kept for per-field conservative regrids,
    interp_as_bundle=.false.). Returns [(out_name, arr, units, desc)]."""
    batch = _ApplyBatch(rg, dtype, root_only=root_only)
    res = []
    batch.add_stack(data, specs, ndim, res.extend)
    batch.run()
    return res


def restagger_u_midpoint(mass):
    """(ny, nx, nz) mass -> (ny, nx+1, nz) EDGE1 by index-space midpoints.
    Kept as the cheap approximation the weight-based restagger is measured
    against (tests/test_restagger.py quantifies the deviation); production
    uses the edge1/edge2 ELL operators (weights/restagger.py)."""
    ny, nx = mass.shape[:2]
    out = np.zeros((ny, nx + 1) + mass.shape[2:], dtype=mass.dtype)
    out[:, 1:nx] = 0.5 * (mass[:, :-1] + mass[:, 1:])
    return out


def restagger_v_midpoint(mass):
    ny, nx = mass.shape[:2]
    out = np.zeros((ny + 1, nx) + mass.shape[2:], dtype=mass.dtype)
    out[1:ny, :] = 0.5 * (mass[:-1, :] + mass[1:, :])
    return out


def _make_regridder(ell: ELLWeights, dtype, mesh=None,
                    precision="highest", source_decomp="replicate",
                    cache_dir=None):
    """Pick the apply engine: the slab-matmul path for f32 2-D grids
    (ops/matmul_apply), falling back to the plain gather Regridder for f64
    runs, 1-D targets, or pathological tiles. With ``mesh``
    (n_device_shards > 1), the operator is sharded across devices; with
    source_decomp="ring"/"allgather" the SOURCE is sharded too and the
    halo exchanged between devices (the reference's route-handle comm,
    interp.F90:123-134) — the memory-bounded multi-device configuration."""
    if mesh is not None and source_decomp != "replicate":
        from ..parallel.sharding import SourceShardedRegridder

        return SourceShardedRegridder(ell, mesh, dtype=dtype,
                                      comm=source_decomp)
    if dtype == jnp.float32 and len(ell.dst_shape) == 2:
        try:
            from ..ops.matmul_apply import SlabMatmulRegridder

            return SlabMatmulRegridder(ell, mesh=mesh, precision=precision,
                                       cache_dir=cache_dir)
        except ValueError:
            pass
    if mesh is not None:
        from ..parallel.sharding import ShardedRegridder

        return ShardedRegridder(ell, mesh, dtype=dtype)
    return Regridder(ell, dtype=dtype)


def _device_mesh(cfg):
    """1-D device mesh for n_device_shards, or None for single-device."""
    n = cfg.n_device_shards
    if n in (0, 1):
        return None
    import jax

    devs = jax.devices()
    if n == -1:
        n = len(devs)
    if n > len(devs):
        raise ValueError(
            f"n_device_shards={n} but only {len(devs)} devices present")
    from ..parallel.sharding import make_grid_mesh

    mesh = make_grid_mesh(devs[:n])
    log.info("- device mesh: %d devices (%s)", mesh.devices.size,
             ", ".join(str(d) for d in mesh.devices.flat))
    return mesh


@dataclasses.dataclass
class PipelineArtifacts:
    """Intermediate state, exposed for tests/benchmarks."""

    cfg: Config
    grid: TargetGrid
    mesh: MPASMesh
    routing: Routing
    data: InputData
    result: RegridResult
    regridders: dict
    timings: Timings


def build_weights(cfg: Config, mesh: MPASMesh, grid: TargetGrid,
                  routing: Routing) -> dict:
    """Generate (or load cached) every weight set the routing needs."""
    cache = WeightCache(cfg.weights_cache_dir)
    fpm, fpg = mesh.fingerprint(), grid_fingerprint(grid)
    out: dict[str, ELLWeights] = {}

    def get(tag, builder):
        return cache.get_or_build(tag, fpm, fpg, builder)

    out["bilinear"] = get(
        "bilinear", lambda: bilinear_cell_weights(mesh, grid.lat, grid.lon))
    if routing.nstd_2d or routing.soil_method() == "nearest":
        out["nearest"] = get(
            "nearest", lambda: nearest_weights(mesh, grid.lat, grid.lon))
    if routing.cons_2d or routing.soil_method() == "conserve":
        out["conserve"] = get(
            "conserve", lambda: conservative_weights(mesh, grid))
    if routing.vert_3d:
        out["vertex"] = get(
            "vertex", lambda: bilinear_vertex_weights(mesh, grid.lat, grid.lon))
    # center -> edge-stagger spherical bilinear (interp.F90:295-328);
    # depends only on the target grid (mesh_fp kept for a uniform key layout)
    if routing.do_u:
        out["edge1"] = get("edge1", lambda: edge1_weights(grid))
    if routing.do_v:
        out["edge2"] = get("edge2", lambda: edge2_weights(grid))
    return out


def run_pipeline(cfg: Config, dtype=jnp.float32) -> PipelineArtifacts:
    import contextlib

    # SURVEY §5 sanitizer row: the reference's debug builds trap FP
    # exceptions (-ffpe-trap=invalid,zero,overflow, CMakeLists.txt:36);
    # MPASSIT_DEBUG_NANS=1 arms jax_debug_nans (every jitted op re-checked)
    # plus the host-side per-field guard in _stack_apply below.
    if os.environ.get("MPASSIT_DEBUG_NANS") == "1":
        jax.config.update("jax_debug_nans", True)
    # persistent XLA compile cache: amortizes compiles across runs, like
    # the weight cache amortizes RegridStore
    from ..compilecache import enable_compile_cache

    enable_compile_cache()
    # SURVEY §5 tracing row: opt-in jax.profiler trace of the whole run
    prof_dir = os.environ.get("MPASSIT_PROFILE")
    profile_cm = (jax.profiler.trace(prof_dir) if prof_dir
                  else contextlib.nullcontext())
    with profile_cm:
        return _run_pipeline(cfg, dtype)


def _run_pipeline(cfg: Config, dtype=jnp.float32) -> PipelineArtifacts:
    timings = Timings()
    with _Timer(timings, "define_target_grid"):
        grid = build_target_grid(cfg)
    with _Timer(timings, "define_input_grid"):
        mesh = mesh_from_file(cfg.grid_file_input_grid)

    routing = build_routing(cfg.varlist_dir, cfg.interp_diag,
                            cfg.interp_hist, cfg.wrf_mod_vars)
    if not cfg.interp_diag and not cfg.interp_hist:
        # input_data.F90:114 error_handler message, verbatim
        from ..errors import FatalError

        raise FatalError(
            "SET INTERP_DIAG AND/OR INTERP_HIST TO TRUE TO OBTAIN OUTPUT")

    data = InputData()
    # ingest dtype (item 3): f32 unless the strict -r8 analog is requested
    # — the f32 engines cast on upload anyway, so f64 ingest only doubled
    # host residency
    in_dtype = (np.float64
                if dtype == jnp.float64 or cfg.compute_dtype == "float64"
                else np.float32)
    with _Timer(timings, "read_input_data"):
        if cfg.interp_diag:
            read_diag_data(cfg.diag_file_input_grid, routing, data,
                           cfg.interp_hist, dtype=in_dtype)
        if cfg.interp_hist:
            read_hist_data(cfg.hist_file_input_grid, routing, data,
                           dtype=in_dtype)

    # Reference parity: block_decomp_file is validated when provided
    # (model_grid.F90:437); sharding replaces it as the actual decomposition.
    if cfg.block_decomp_file != "NULL":
        from ..parallel.decomp import read_block_decomp_file

        read_block_decomp_file(cfg.block_decomp_file, mesh.ncells)

    # Input/grid dim consistency: a field sized for a different mesh would
    # silently misindex the weight apply (the reference hits an ESMF
    # scatter-shape abort instead; utils.F90:16-33 fail-fast contract).
    from ..errors import FatalError

    for name, arr in data.fields.items():
        n_expect = (mesh.nvertices
                    if any(s.in_name == name for s in routing.vert_3d)
                    else mesh.ncells)
        if arr.shape[0] != n_expect:
            raise FatalError(
                f"FIELD {name} HAS {arr.shape[0]} CELLS BUT THE MPAS GRID "
                f"FILE HAS {n_expect}")
    for wname, warr in (("uReconstructZonal", data.u),
                        ("uReconstructMeridional", data.v)):
        if warr is not None and warr.shape[0] != mesh.ncells:
            raise FatalError(
                f"FIELD {wname} HAS {warr.shape[0]} CELLS BUT THE MPAS GRID "
                f"FILE HAS {mesh.ncells}")

    # cell_order='morton': renumber source cells along a Z-curve over the
    # target's index space BEFORE weight generation, so each target tile's
    # slab gather reads a compact span of device memory (the locality role of the
    # reference's METIS decomposition, model_grid.F90:2367-2426). Fields
    # already read are permuted into the new numbering; vertex-located
    # fields keep their (unchanged) vertex numbering. Weights are generated
    # on the renumbered mesh, so results are unchanged (tests pin this).
    if cfg.cell_order == "morton":
        from ..mesh.reorder import (
            apply_perm,
            reorder_cells_by_latitude,
            reorder_cells_morton,
        )

        ro = (reorder_cells_morton(mesh, grid.proj)
              if grid.proj is not None else reorder_cells_by_latitude(mesh))
        mesh = ro.mesh
        vert_names = {s.in_name for s in routing.vert_3d}
        for k in list(data.fields):
            if k not in vert_names:
                data.fields[k] = apply_perm(data.fields[k], ro.perm)
        if data.u is not None:
            data.u = apply_perm(data.u, ro.perm)
        if data.v is not None:
            data.v = apply_perm(data.v, ro.perm)

    with _Timer(timings, "weight_generation"):
        weights = build_weights(cfg, mesh, grid, routing)
        dev_mesh = _device_mesh(cfg)
        rgs = {k: _make_regridder(v, dtype, mesh=dev_mesh,
                                  precision=cfg.apply_precision,
                                  source_decomp=cfg.source_decomp,
                                  cache_dir=cfg.weights_cache_dir)
               for k, v in weights.items()}

    res = RegridResult(nz=mesh.nz, nzp1=mesh.nzp1, nsoil=mesh.nsoil)
    np_dtype = np.float64 if dtype == jnp.float64 else np.float32

    with _Timer(timings, "interp_data"):
        # One _ApplyBatch per weight operator: every stack routed to the
        # same method rides ONE slab gather + ONE apply (cross-bundle
        # packing — the reference pays one ESMF SMM per bundle,
        # interp.F90:119-447; narrow stacks no longer each pay a full
        # padded-width output).
        batches: dict[str, _ApplyBatch] = {}
        root_only = cfg.fetch_root_only

        # streaming output (VERDICT r3 item 2): create the FULL output
        # schema now, then every apply below writes its fetched strips
        # straight into the file. Multi-process (VERDICT r4 item 3):
        # process 0 drives the real StreamingWriter (the rank-0 serial
        # write, write_data.F90:1005-1475); every other process runs the
        # identical SPMD program with a NullStreamWriter — it participates
        # in each strip's fetch collective and drops the strip, so NO
        # process ever materializes the full output block.
        writer = None
        deferred: dict = {}
        if cfg.stream_output:
            from ..io.wrf_writer import NullStreamWriter, StreamingWriter

            plan = _build_stream_plan(cfg, routing, data)
            if jax.process_index() == 0:
                with _Timer(timings, "write_to_file"):
                    writer = StreamingWriter(
                        cfg.output_file, cfg, grid, data, plan, mesh.nz,
                        mesh.nzp1, mesh.nsoil, mesh.zs).open()
            else:
                writer = NullStreamWriter()
                log.info("- streaming: process %d participates in strip "
                         "fetches and drops them (no full-output buffer)",
                         jax.process_index())

        def batch_for(key: str) -> _ApplyBatch:
            # terminal fields may gather to process 0 only (the reference's
            # rootPet=0 FieldGather, write_data.F90:1006)
            if key not in batches:
                batches[key] = _ApplyBatch(rgs[key], np_dtype,
                                           root_only=root_only)
            return batches[key]

        # wind mass fields feed the SHARDED edge restagger, so every
        # process needs the real values: always gather-to-all
        wind_batch = _ApplyBatch(rgs["bilinear"], np_dtype, root_only=False)
        # degeneracy guard (register R11): warn before any Q4 rotation if
        # the grid's rotation angles approach 90 deg (|cosa| -> 0)
        if cfg.proj_code == PROJ_LC and grid.cosa is not None:
            from ..ops.rotate import check_rotation_angles

            check_rotation_angles(grid.cosa)
        wind = {}
        d2 = []
        if cfg.interp_diag:
            d2 = [s for s in routing.diag if data.fields[s.in_name].ndim == 1]
            d3 = [s for s in routing.diag if data.fields[s.in_name].ndim == 2]
            batch_for("bilinear").add_stack(
                data, d2, 2, lambda r: setattr(res, "diag2d", r))
            batch_for("bilinear").add_stack(
                data, d3, 3, lambda r: setattr(res, "diag3d", r))
            if writer is not None and cfg.proj_code == PROJ_LC:
                # U10/V10 await the post-apply Q4 rotation: buffer them
                # instead of streaming unrotated values
                m2 = {s.in_name: s.out_name for s in d2}
                if "u10" in m2 and "v10" in m2:
                    batch_for("bilinear").defer = frozenset(
                        (m2["u10"], m2["v10"]))

        if cfg.interp_hist:
            bil = batch_for("bilinear")
            bil.add_stack(data, routing.patch_2d, 2,
                          lambda r: setattr(res, "patch2d", r))
            bil.add_stack(data, routing.nz_3d, 3,
                          lambda r: setattr(res, "nz3d", r))
            bil.add_stack(data, routing.nzp1_3d, 3,
                          lambda r: setattr(res, "nzp13d", r))
            if routing.vert_3d:
                batch_for("vertex").add_stack(
                    data, routing.vert_3d, 3,
                    lambda r: setattr(res, "vert3d", r))
            if routing.cons_2d:
                if cfg.interp_as_bundle:
                    batch_for("conserve").add_stack(
                        data, routing.cons_2d, 2,
                        lambda r: setattr(res, "cons2d", r))
                elif writer is not None:
                    # per-field conservative applies, streamed
                    for s in routing.cons_2d:
                        def put1(name):
                            return lambda lo, st: writer.put(
                                name, 0, st[:, :, 0])
                        rg = rgs["conserve"]
                        if getattr(rg, "accepts_blocks", False):
                            rg.apply_np(data.fields[s.in_name],
                                        strip_sink=put1(s.out_name))
                        else:
                            writer.put(s.out_name, 0,
                                       rg.apply_np(data.fields[s.in_name]))
                else:
                    # interp_as_bundle=.false.: conservative fields regridded
                    # one at a time (interp.F90:368-416; the reference notes
                    # it is "faster and less memory intensive" — here it
                    # bounds device memory to one field per apply)
                    res.cons2d = [
                        one
                        for s in routing.cons_2d
                        for one in _stack_apply(rgs["conserve"], data, [s], 2,
                                                np_dtype,
                                                root_only=root_only)
                    ]
            if routing.nstd_2d:
                batch_for("nearest").add_stack(
                    data, routing.nstd_2d, 2,
                    lambda r: setattr(res, "nstd2d", r))
            if routing.soil:
                # quirk Q3: soil joins whatever method's batch the carryover
                # picked — with default lists that packs it into the nstd
                # nearest apply
                batch_for(routing.soil_method()).add_stack(
                    data, routing.soil, 3, lambda r: setattr(res, "soil", r))
            # staggered winds, first hop: mesh -> mass points
            # (interp.F90:256-289); packed into the bilinear mega-bundle
            # unless terminal fields are root-only (the mass winds must
            # reach every process for the sharded restagger). Under Lambert
            # the parts carry rot tags so the packed apply can rotate them
            # inside the apply (quirk Q4) instead of a post-hoc device
            # round-trip.
            wb = wind_batch if root_only else bil
            rot_lc = (routing.do_u and routing.do_v
                      and cfg.proj_code == PROJ_LC and wb is bil)
            if routing.do_u:
                wb.add(data.u, lambda a: wind.__setitem__("u", a),
                       tag="rot_u" if rot_lc else None)
            if routing.do_v:
                wb.add(data.v, lambda a: wind.__setitem__("v", a),
                       tag="rot_v" if rot_lc else None)

        # hgt always regridded when hist (interp.F90:226-238); the target
        # HGT ('file' path) is available but the reference overwrites it
        # with the mesh 'ter' regrid.
        # CONSCIOUS DEVIATION (documented): for diag-only runs without a
        # target-file HGT the reference would write an UNINITIALIZED field
        # (its hgt regrid runs only under interp_hist); we regrid mesh
        # 'ter' instead of emitting garbage.
        if cfg.interp_hist or grid.hgt is None:
            batch_for("bilinear").add(
                mesh.ter, lambda a: setattr(res, "hgt", a),
                stream=[("HGT", None)])
        else:
            res.hgt = grid.hgt
            if writer is not None:
                writer.put("HGT", 0, np.asarray(grid.hgt, np.float32))

        winds_rotated = _run_batches_packed(batches, rgs, weights, np_dtype,
                                            root_only, grid=grid,
                                            writer=writer, deferred=deferred)
        for b in batches.values():
            b.run(writer=writer, deferred=deferred)
        wind_batch.run()

        if cfg.interp_diag:
            # 10-m wind rotation (interp.F90:138-140, wind_dim=2)
            names2 = [s.in_name for s in d2]
            if "u10" in names2 and "v10" in names2 and cfg.proj_code == PROJ_LC:
                if writer is not None:
                    # rotation feeds only the file: primary-only (non-root
                    # puts are no-ops, and under fetch_root_only its
                    # deferred buffers were never filled); no collectives
                    # inside, so skipping on non-root keeps SPMD intact
                    if jax.process_index() == 0:
                        uo = d2[names2.index("u10")].out_name
                        vo = d2[names2.index("v10")].out_name
                        u, v = rotate_winds(
                            jnp.asarray(deferred[uo][0][:, :, 0]),
                            jnp.asarray(deferred[vo][0][:, :, 0]),
                            jnp.asarray(grid.cosa, dtype=dtype),
                            jnp.asarray(grid.sina, dtype=dtype))
                        writer.put(uo, 0, np.asarray(u, np.float32))
                        writer.put(vo, 0, np.asarray(v, np.float32))
                else:
                    iu, iv = names2.index("u10"), names2.index("v10")
                    u, v = rotate_winds(
                        jnp.asarray(res.diag2d[iu][1]),
                        jnp.asarray(res.diag2d[iv][1]),
                        jnp.asarray(grid.cosa, dtype=dtype),
                        jnp.asarray(grid.sina, dtype=dtype))
                    res.diag2d[iu] = (res.diag2d[iu][:1] + (np.asarray(u),)
                                      + res.diag2d[iu][2:])
                    res.diag2d[iv] = (res.diag2d[iv][:1] + (np.asarray(v),)
                                      + res.diag2d[iv][2:])

        if cfg.interp_hist:
            # staggered winds (interp.F90:256-328, quirks Q4/Q6); skipped
            # when the packed apply already rotated them
            umass, vmass = wind.get("u"), wind.get("v")
            if (routing.do_u and routing.do_v and cfg.proj_code == PROJ_LC
                    and not winds_rotated):
                u, v = rotate_winds(jnp.asarray(umass), jnp.asarray(vmass),
                                    jnp.asarray(grid.cosa, dtype=dtype),
                                    jnp.asarray(grid.sina, dtype=dtype))
                umass, vmass = np.asarray(u), np.asarray(v)
            # center -> EDGE1/EDGE2 spherical bilinear regrid (quirk Q6,
            # interp.F90:295-328) through the same apply engines
            def restagger(key, var, mass):
                m = mass.reshape(grid.n_points, -1)
                rg = rgs[key]
                if writer is None:
                    return rg.apply_np(m, root_only=root_only)
                if getattr(rg, "accepts_blocks", False):
                    rg.apply_np(m, strip_sink=lambda lo, s:
                                writer.put(var, lo, s))
                else:
                    writer.put(var, 0, rg.apply_np(m))
                return None

            if routing.do_u:
                res.u = restagger("edge1", "U", umass)
            if routing.do_v:
                res.v = restagger("edge2", "V", vmass)
        res.zs = mesh.zs

    if writer is not None:
        t0 = time.perf_counter()
        writer.finish()
        dt = time.perf_counter() - t0
        timings.add("write_to_file", dt)
        # the part of the write the pipeline actually WAITED on (the
        # schema-creation open is charged to write_to_file but is not
        # hideable); overlap = 1 - finish_wait / stream_write
        timings.stages["stream_finish_wait_s"] = dt
        timings.stages["stream_write_s"] = writer.stats["t_write_s"]

    # test hook: dump the full-precision regrid results before the f32
    # NetCDF write, so cross-process bit-parity can be asserted at compute
    # precision (the file caps agreement at f32 rounding). Streaming mode
    # holds no arrays — every process dumps its (empty) holdings so tests
    # can assert that no process materialized the output (VERDICT r4 #3).
    dump = os.environ.get("MPASSIT_DUMP_RESULT")
    if dump and (writer is not None or jax.process_index() == 0):
        arrs = {}
        for cat in ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d",
                    "vert3d", "cons2d", "nstd2d", "soil"):
            for name, arr, *_ in getattr(res, cat, None) or []:
                arrs[f"{cat}.{name}"] = arr
        for name in ("u", "v", "hgt"):
            if getattr(res, name, None) is not None:
                arrs[name] = getattr(res, name)
        np.savez(dump, **arrs)

    # serial write on process 0 only (the reference's rank-0 NetCDF write,
    # write_data.F90); single-host this is always True. Streaming mode
    # already wrote everything strip by strip.
    if writer is None and jax.process_index() == 0:
        with _Timer(timings, "write_to_file"):
            write_output(cfg.output_file, cfg, grid, data, res)

    return PipelineArtifacts(cfg=cfg, grid=grid, mesh=mesh, routing=routing,
                             data=data, result=res, regridders=rgs,
                             timings=timings)


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    nml = argv[0] if argv else "./fort.41"  # mpassit.F90:52-65 default
    from ..parallel.multihost import maybe_init_distributed

    maybe_init_distributed()
    from ..errors import FatalError

    try:
        # mpassit.F90:55-65: abort when the namelist path does not exist
        if not os.path.exists(nml):
            raise FatalError(f"namelist file - {nml} does not exist.")
        cfg = Config.from_namelist(nml)
        # esmf_log maps to verbose logging (the reference's ESMF PET error
        # logs, program_setup.F90:139-143)
        logging.basicConfig(
            level=logging.DEBUG if cfg.esmf_log else logging.INFO,
            format="%(message)s")
        if cfg.compute_dtype == "float64":
            jax.config.update("jax_enable_x64", True)
        art = run_pipeline(cfg, dtype=jnp.float64
                           if cfg.compute_dtype == "float64" else jnp.float32)
    except FatalError as e:
        # error_handler/netcdf_err banner + abort (utils.F90:16-58); exit
        # code 999 truncates to 231 like mpi_abort's shell status
        print(e.banner(), file=sys.stderr)
        return 999 & 0xFF
    # one-line run summary: host stage seconds and the device's peak
    # memory (memory_stats is None on backends that keep no statistics)
    import json

    log.info("- timings: %s", json.dumps(
        {k: round(v, 3) for k, v in art.timings.stages.items()}))
    stats = jax.local_devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log.info("- device peak bytes in use: %d", stats["peak_bytes_in_use"])
    log.info("- DONE.")
    return 0
