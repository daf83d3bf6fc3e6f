"""Multi-host runtime initialization (the MPI_Init / ESMF VM replacement).

The reference launches N MPI ranks and wraps them in an ESMF VM
(``mpassit.F90:71,89-96``). The JAX equivalent is its distributed runtime:
one Python process per host, each seeing its local devices, with
collectives between them handled by XLA's collective library.

Usage (per host)::

    from mpassit_jax.parallel.multihost import maybe_init_distributed
    maybe_init_distributed()          # no-op on a single host

Initialization is driven by environment variables so that the same CLI
invocation works single- and multi-host:

- ``MPASSIT_COORDINATOR``  address of process 0, e.g. ``10.0.0.1:8476``
- ``MPASSIT_NUM_PROCESSES``  world size
- ``MPASSIT_PROCESS_ID``  this host's rank

(or any standard launcher JAX auto-detects — SLURM, Open MPI, GKE — in which
case ``jax.distributed.initialize()`` needs no arguments and we pass none).

After initialization, ``jax.devices()`` spans every chip in the job, so the
pipeline's ``n_device_shards=-1`` shards the apply over the full slice; the
output gather (``write_to_file``) runs on process 0 only, matching the
reference's rank-0 serial NetCDF write (``write_data.F90``).
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("mpassit_jax")

_ENV_COORD = "MPASSIT_COORDINATOR"
_ENV_NPROC = "MPASSIT_NUM_PROCESSES"
_ENV_PID = "MPASSIT_PROCESS_ID"


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed when multi-host env vars (or an
    auto-detectable launcher) are present. Returns True when a multi-host
    runtime was initialized. Idempotent; safe to call on a single host."""
    import jax

    coord = os.environ.get(_ENV_COORD)
    nproc = os.environ.get(_ENV_NPROC)
    pid = os.environ.get(_ENV_PID)
    if coord is None and nproc is None:
        return False
    try:
        if coord is not None:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(nproc) if nproc else None,
                process_id=int(pid) if pid else None,
            )
        else:
            jax.distributed.initialize()
    except RuntimeError as e:
        # already initialized (idempotence)
        if "already" not in str(e):
            raise
    log.info("- distributed runtime: process %d of %d, %d devices",
             jax.process_index(), jax.process_count(),
             len(jax.devices()))
    return True


def is_primary() -> bool:
    """True on the process that owns the output write (rank 0 analog)."""
    import jax

    return jax.process_index() == 0


def fetch_to_host(x, root_only: bool = False):
    """Bring a (possibly cross-process sharded) jax.Array to a host numpy
    array — the ESMF_FieldGather analog (write_data.F90:1006).

    Default is gather-to-all so each process can keep executing the
    identical SPMD program; process 0 alone writes the file.
    ``root_only=True`` is the reference's gather-to-rank-0 pattern
    (write_data.F90:1006): every process still participates in the
    collective (SPMD requirement), but only process 0 pays the host copy —
    the others get None. Use ONLY for terminal fields headed straight to
    the writer; a root-only result must never feed a later sharded apply
    (non-root processes would contribute garbage shards).

    np.asarray on a multi-process sharded array raises (non-addressable
    shards); process_allgather assembles it over the collective fabric."""
    import numpy as np

    if isinstance(x, np.ndarray):
        return x
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(x, tiled=True)
    if root_only and not is_primary():
        return None
    return np.asarray(gathered)
