"""Multi-host SPMD setup and film assembly (SURVEY.md §5.8, DCN plane).

On a multi-host cluster every host runs this same program under
``jax.distributed.initialize``; collectives within a host ride shard_map
(dist/mesh.py), and the pieces here cover the host-side plumbing:

- ``init_distributed``: one call with an explicit coordinator address,
  process count and process id. Safe no-op for single-process runs.
- ``global_ray_mesh``: a 1-D ('rays',) mesh over ALL devices of all hosts
  — tile/ray sharding spans the host boundary transparently; XLA routes
  the collective legs within a host's cards and across the network.
- ``assemble_film``: host 0 gathers the film from a globally-sharded
  array via multihost_utils (each host computed its shard locally).
- ``host_local_slice``: which rows of the film this host owns — for
  host-local I/O (each host writes its own shard, SURVEY.md §5.8).

Real multi-host execution needs several hosts; tests exercise the
single-process degenerate forms (``__graft_entry__.dryrun_multichip``
covers the sharded compile path on a virtual mesh).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-process JAX runtime. No-op when single-process
    and no coordinator is given."""
    if num_processes is None and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_ray_mesh(axis_name: str = "rays") -> Mesh:
    """1-D mesh over every device of every participating host."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def process_info() -> Tuple[int, int]:
    return jax.process_index(), jax.process_count()


def host_local_slice(total_rows: int) -> slice:
    """Rows of a row-sharded film owned by this host (even split)."""
    pid, pcount = process_info()
    per = -(-total_rows // pcount)
    lo = min(pid * per, total_rows)
    hi = min(lo + per, total_rows)
    return slice(lo, hi)


def assemble_film(film_global) -> np.ndarray:
    """Gather a (possibly sharded) global film to every host as numpy.

    Uses multihost_utils.process_allgather under multi-process execution;
    single-process it is just np.asarray.
    """
    if jax.process_count() == 1:
        return np.asarray(film_global)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(film_global, tiled=True)
    )
