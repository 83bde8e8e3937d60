"""Multi-host (DCN) distribution: jax.distributed wiring + host-local work.

The reference scales across machines by launching one ROS process per
sequence by hand (SURVEY.md §2.3); the equivalent here is JAX
multi-process SPMD: every host runs THIS same program, `initialize()` wires
the processes into one runtime over DCN, and a global mesh spanning all
hosts' devices carries the `seq` axis.  Each host feeds only the sequences
whose shards live on its local devices (`host_sequence_slice` +
`make_global_batch`) — image streams never cross the data-center network;
only the XLA collectives inside sharded programs do (and the multi-sequence
DP programs have none in steady state, so DCN sees pure orchestration
traffic).

Launch recipe (2 hosts, 11 EuRoC sequences padded to 12):

    # host 0                                  # host 1
    FLVIS_COORD=host0:8476 \
    python examples/run_multiseq.py \
      --processes 2 --process-id 0 ...        ... --process-id 1 ...

where the driver calls `multihost.initialize(coord, 2, pid)` FIRST (before
any jax array/device touch), builds `mesh = multiseq.make_mesh()` over
`jax.devices()` (now global), and feeds `make_global_batch` with the
host-local sequence block.  Scaling target (BASELINE.md): ≥ 0.7 efficiency
at 2+ hosts — the workload is embarrassingly parallel, so the loss budget
is orchestration + the final trajectory gather only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int = 1, process_id: int = 0,
               local_device_ids=None) -> None:
    """Wire this process into the multi-host JAX runtime.

    Must be called before any other JAX API touches a backend (device
    queries, array creation, compiles).  The single-process case is a no-op:
    no coordinator service is needed, and skipping the call keeps
    single-host runs (tests, one-box replay) free of the distributed
    runtime's socket setup.
    """
    if num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("multi-process runs need coordinator_address "
                         "(host:port reachable from every process)")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def host_sequence_slice(num_seqs: int, mesh: Mesh, axis: str = "seq") -> slice:
    """The contiguous block of sequence indices THIS process must load.

    Sequences are laid out along the mesh's `seq` axis in device order;
    with the default mesh construction, consecutive index blocks land on
    consecutive processes, so each host's block is contiguous.  num_seqs
    must be divisible by the axis size (pad the run list — the standard
    "11 EuRoC runs → 12 slots" trick).
    """
    n_dev = mesh.shape[axis]
    if num_seqs % n_dev:
        raise ValueError(f"num_seqs={num_seqs} not divisible by mesh "
                         f"axis size {n_dev}; pad the sequence list")
    per_dev = num_seqs // n_dev
    local = [d for d in mesh.devices.ravel()
             if d.process_index == jax.process_index()]
    if not local:
        return slice(0, 0)
    idx = sorted(np.nonzero(
        [d.process_index == jax.process_index()
         for d in mesh.devices.ravel()])[0])
    lo, hi = idx[0], idx[-1] + 1
    if list(range(lo, hi)) != list(idx):
        raise ValueError("process's devices are not contiguous on the seq "
                         "axis; use the default mesh construction")
    return slice(lo * per_dev, hi * per_dev)


def make_global_batch(mesh: Mesh, local_batch, axis: str = "seq"):
    """Assemble a globally-sharded batch pytree from HOST-LOCAL data.

    local_batch leaves are the (S_local, ...) arrays for this host's
    sequence block (host_sequence_slice); the result is a (S_global, ...)
    jax.Array sharded over the mesh's seq axis whose local shards alias this
    host's data — no cross-host transfer happens here or later.
    """
    def put(a):
        a = np.asarray(a)
        spec = P(*((axis,) + (None,) * (a.ndim - 1)))
        sharding = NamedSharding(mesh, spec)
        n_dev = mesh.shape[axis]
        global_shape = (a.shape[0] * n_dev // max(1, _local_dev_count(mesh)),) \
            + a.shape[1:]
        return jax.make_array_from_process_local_data(sharding, a, global_shape)

    return jax.tree.map(put, local_batch)


def _local_dev_count(mesh: Mesh) -> int:
    return sum(d.process_index == jax.process_index()
               for d in mesh.devices.ravel())


def init_system_states_global(fcfg, bcfg, num_seqs: int, mesh: Mesh,
                              vcfg=None, axis: str = "seq"):
    """multiseq.init_system_states for a MULTI-PROCESS global mesh.

    The single-process version builds host arrays and device_puts them onto
    the mesh; with processes owning disjoint device subsets that put cannot
    span non-addressable devices.  Here the batched initial states are
    constructed INSIDE one jit program with sharded out_shardings — every
    process compiles the same SPMD program and each materializes only its
    own shards.
    """
    from ..backend import window_ba
    from ..frontend import tracker
    from ..vio import vimotion

    def build():
        ones = [tracker.init_state(fcfg), window_ba.empty(bcfg),
                window_ba.null_correction(bcfg)]
        if vcfg is not None:
            ones.append(vimotion.init_state(vcfg))
        return tuple(
            jax.tree.map(
                lambda a: jnp.broadcast_to(a, (num_seqs,) + a.shape), one)
            for one in ones)

    shapes = jax.eval_shape(build)
    out_sh = jax.tree.map(
        lambda s: NamedSharding(
            mesh, P(*((axis,) + (None,) * (len(s.shape) - 1)))), shapes)
    return jax.jit(build, out_shardings=out_sh)()


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that should write trajectories/benchmarks."""
    return jax.process_index() == 0


def gather_to_host(x):
    """Fetch a (possibly cross-host-sharded) array fully to this host —
    results-path only (trajectory exports), never in the frame loop."""
    return np.asarray(jax.device_get(
        jax.jit(lambda a: a, out_shardings=None)(x)))
