# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Multi-host (multi-process) initialization for cluster runs.

The reference's cluster scale-out story is swapping its solver for an
MPI-launched C++ program (``qiskit-addon-dice-solver``; the reference's
``docs/guides/integrate_dice_solver.ipynb``).  The JAX
equivalent is SPMD: every host process runs the SAME program,
``jax.distributed.initialize`` wires the processes into one runtime, and the
existing ``shard_map`` solvers (:mod:`~sqd_tpu.parallel.batch_solver`,
:mod:`~sqd_tpu.parallel.row_sharded`, :mod:`~sqd_tpu.parallel.grid_sharded`)
run unchanged over a global mesh whose devices span all hosts — batch
fan-out and intra-solve collectives ride the device interconnect within a
host and the network across hosts.

Typical launcher (one process per host; the coordinator address, world size
and rank come from the arguments or the ``SQD_TPU_*`` variables)::

    import sqd_tpu.parallel as par
    par.init_distributed()                      # no-op off-cluster
    mesh = par.global_mesh("batch")             # devices from every process
    results = par.solve_sci_batch_sharded(..., mesh=mesh)

Single-process (one host, any number of local devices) is the degenerate
case: :func:`init_distributed` returns ``False`` without touching the
runtime, and ``global_mesh`` equals the local-device mesh.  The mesh
construction and spec plumbing are unit-tested in the degenerate case
(``tests/test_parallel.py``), the sharded solvers themselves are validated
on the virtual 8-device mesh, and ``tests/test_distributed_multiprocess.py``
runs a real 2-process CPU runtime.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["init_distributed", "global_mesh", "is_distributed"]

_INITIALIZED = False


def is_distributed() -> bool:
    """True when more than one process participates in the runtime."""
    return jax.process_count() > 1


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    platform: str | None = None,
) -> bool:
    """Join this process into a multi-host JAX runtime (idempotent).

    All arguments default from the environment, in order of precedence:
    explicit argument > ``SQD_TPU_*`` variable.  Recognized variables:

    * ``SQD_TPU_COORDINATOR`` — ``host:port`` of process 0;
    * ``SQD_TPU_NUM_PROCESSES`` — world size;
    * ``SQD_TPU_PROCESS_ID`` — this process's rank.

    ``platform="cpu"`` pins the runtime to CPU devices and selects the Gloo
    cross-process collectives implementation — the multi-host-on-CPU path
    used by CI (``tests/test_distributed_multiprocess.py`` runs a real
    2-process row-sharded solve through it).  On GPUs leave it unset;
    collectives go through NCCL.

    Returns ``True`` if a multi-process runtime was (or already had been)
    initialized, ``False`` for the single-process degenerate case (no
    configuration present) — in which case nothing was modified and all
    solvers keep working on local devices.
    """
    global _INITIALIZED
    if platform is not None:
        jax.config.update("jax_platforms", platform)
        if platform == "cpu":
            # cross-process CPU collectives need an explicit implementation
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if _INITIALIZED or jax.distributed.is_initialized():
        # idempotent: our own earlier call, or the user wired the runtime
        # directly via jax.distributed.initialize (is_initialized inspects
        # the distributed client only — it does NOT force backend init, which
        # must stay untouched until after a potential initialize below)
        _INITIALIZED = True
        return True
    coordinator_address = coordinator_address or os.environ.get("SQD_TPU_COORDINATOR")
    if num_processes is None and "SQD_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SQD_TPU_NUM_PROCESSES"])
    if process_id is None and "SQD_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SQD_TPU_PROCESS_ID"])
    if coordinator_address is None:
        return False  # single process: degenerate case, nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as exc:  # pragma: no cover - raced pre-initialization
        # the runtime was already wired between our is_initialized check and
        # this call; treat as success.  Primary signal: the runtime now
        # reports initialized (version-proof).  Message matching ("already" /
        # JAX 0.9's "only be called once") kept as fallback for versions
        # whose is_initialized lags the raise.
        msg = str(exc).lower()
        if not (
            jax.distributed.is_initialized()
            or "already" in msg
            or "only be called once" in msg
        ):
            raise
    _INITIALIZED = True
    return True


def host_local(value):
    """Host (numpy) copy of ``value`` when multi-process, else as-is.

    ``jax.device_put`` onto a mesh spanning non-addressable devices requires
    process-local (host) inputs, every process passing the same global value
    — locally-committed device arrays must round-trip through the host first.
    Single-process, the value passes through untouched (device_put reshards
    device arrays directly, no copy).
    """
    return np.asarray(value) if jax.process_count() > 1 else value


def replicate_to_host(value, mesh: Mesh) -> np.ndarray:
    """Host copy of a (possibly sharded) global array, on every process.

    Multi-host: first force a replicated layout (one compiled all-gather) so
    each process holds the full value — reading back an array that spans
    non-addressable devices raises otherwise.  The caller's host-side
    epilogue then runs redundantly-but-identically per process (SPMD
    discipline, no cross-host jits).  Single-process: plain ``np.asarray``.
    """
    if jax.process_count() > 1:
        from jax.sharding import NamedSharding, PartitionSpec

        value = jax.jit(
            lambda v: v, out_shardings=NamedSharding(mesh, PartitionSpec())
        )(value)
    return np.asarray(value)


def global_mesh(*axis_names: str, axis_sizes: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over the GLOBAL device set (all processes' devices).

    With one axis name the mesh is 1-D over every device (the batch fan-out
    and row-sharding layout).  With several names, ``axis_sizes`` fixes the
    factorization; by default the FIRST axis absorbs the process count so
    intra-axis collectives of the trailing axes stay within a host's devices
    (ICI) and only the leading axis crosses DCN.
    """
    devices = np.asarray(jax.devices())  # global: includes remote processes
    if not axis_names:
        axis_names = ("batch",)
    if len(axis_names) == 1:
        return Mesh(devices, axis_names)
    if axis_sizes is None:
        lead = jax.process_count()
        rest = devices.size // lead
        if len(axis_names) != 2:
            raise ValueError("pass axis_sizes for meshes with more than two axes")
        axis_sizes = (lead, rest)
    if int(np.prod(axis_sizes)) != devices.size:
        raise ValueError(
            f"axis_sizes {axis_sizes} does not cover {devices.size} devices"
        )
    return Mesh(devices.reshape(axis_sizes), axis_names)
