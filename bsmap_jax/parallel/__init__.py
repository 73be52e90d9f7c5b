"""Multi-device / multi-host scale-out.

The reference scales with pthreads over a shared index (main.cpp:45-131)
plus documented manual multi-process read-range splitting (README.txt:83-86).
The equivalents here:

  * ``make_mesh`` — a 1-D ``jax.sharding.Mesh`` over the "dp" (data-parallel)
    axis.  Reads shard across it; the packed genome + seed index replicate.
  * ``ShardedDeviceEngine`` — the fused alignment step run under
    ``shard_map``: each device aligns its own stripe of reads against the
    replicated index; per-chunk aggregate counters merge with ``psum``.
    Bit-exact per read (reads are independent).
  * ``IndexShardedEngine`` — the seed index region-sharded over the mesh,
    reads replicated, results merged with psum/pmin/all_gather.
  * ``distributed`` — multi-process launch helpers: one card per process,
    ``jax.distributed`` init and per-process read-range assignment (the
    -B/-E mechanism made first-class).
"""

from . import distributed
from .mesh import make_mesh
from .sharded import ShardedDeviceEngine
from .index_sharded import IndexShardedEngine

__all__ = ["distributed", "make_mesh", "ShardedDeviceEngine",
           "IndexShardedEngine"]
