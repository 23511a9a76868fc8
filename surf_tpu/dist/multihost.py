"""Multi-process initialization for the sharded render.

With one process per host (or per card), every process runs the same
program; call ``init_multihost()`` before building the mesh so
jax.distributed connects the processes, then build the ('hosts', 'chips')
mesh with ``make_host_chip_mesh``.  The render/grad code in
dist/sharding.py runs unchanged on it: lanes split over both axes, and the
gradient psum spans every card.

Nothing on a single machine announces a cluster, so pass the coordinator
address (``host:port``), the number of processes and this process's id.
The test suite checks the sharding semantics on a virtual 8-device CPU mesh
instead.
"""

from __future__ import annotations

import numpy as np


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """jax.distributed.initialize; with no arguments JAX uses whatever
    cluster environment it detects."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def make_host_chip_mesh():
    """Mesh(('hosts', 'chips')) over all devices, hosts-major.

    Delegates to dist.sharding.make_mesh_2d — the SAME constructor the
    virtual-8-CPU test suite exercises (tests/test_sharding.py 2-D cases),
    so the production multi-host shape is not a faith-based code path.
    dist/sharding.py's layouts shard lanes over both axes
    (P(('hosts', 'chips'))); scene stays fully replicated."""
    import jax

    from .sharding import make_mesh_2d

    n_hosts = jax.process_count()
    per_host = len(jax.devices()) // n_hosts
    return make_mesh_2d(n_hosts, per_host)
