"""Device-mesh construction for the scale-out paths."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """A 1-D mesh over this process's devices (every card reaches every
    other at the same rate, so the mesh follows the algorithm alone).

    The alignment workload is read-parallel: there are no weights, layers, or
    attention, so tensor/pipeline/expert parallelism have no analogue here
    (SURVEY.md §2 parallelism inventory).  The two real axes are reads (dp,
    this mesh) and the genome/index (phase-B index sharding, which reuses
    this mesh with the index partitioned instead of replicated).
    """
    devs = jax.local_devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))
