"""Data-parallel alignment over a device mesh (SURVEY.md §7 phase A).

Each device runs the complete fused schedule+verify step on its own stripe
of reads against a replicated genome + seed index; results are bit-exact
(reads are independent; the per-read myrand selection is stateless).  A
``psum`` over the mesh merges per-chunk aggregate counters so the program
contains the cross-device reduction that phase B (sharded index, cross-
device best-hit merge) will extend.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.device_engine import (Cfg, DeviceEngine, N_EXTRAS, X_FOUND,
                                    _align_fused_kernel)
from ..index import SeedIndex
from ..params import Param
from ..reference import PackedGenome


@functools.partial(jax.jit,
                   static_argnames=("cfg", "cands_loc", "mesh", "axis"))
def _sharded_fused(cfg: Cfg, cands_loc: int, mesh: Mesh, axis: str,
                   prof_a, d_kmer_tab, rc_code, rc_n_code, d_catcat,
                   d_anchors, d_sizes, d_rcoff, d_wlocs, d_clocs,
                   d_tags, d_sites, d_site_off, d_tag_off, packed):
    """shard_map over the read axis: every device aligns its stripe against
    the replicated index; one psum merges the aligned-read counters."""

    def step(prof_a, d_kmer_tab, rc_code, rc_n_code, d_catcat,
             d_anchors, d_sizes, d_rcoff, d_wlocs, d_clocs, d_tags,
             d_sites, d_site_off, d_tag_off, packed):
        out = _align_fused_kernel(
            cfg, cands_loc, prof_a, d_kmer_tab, rc_code, rc_n_code,
            d_catcat, d_anchors, d_sizes, d_rcoff, d_wlocs, d_clocs,
            d_tags, d_sites, d_site_off, d_tag_off, packed)
        # cross-device aggregate: total found reads this chunk (the
        # collective the phase-B sharded-index merge will generalize)
        found = (out[:, 1] & 1) if cfg.lean \
            else out[:, 2 * cfg.maxseg + X_FOUND]
        n_aligned = jax.lax.psum(found.sum(), axis)
        return out, n_aligned[None]

    rep = P()
    shd = P(axis)
    fn = jax.shard_map(step, mesh=mesh,
                       in_specs=(rep,) * 14 + (shd,),
                       out_specs=(shd, P(axis)), check_vma=False)
    return fn(prof_a, d_kmer_tab, rc_code, rc_n_code, d_catcat,
              d_anchors, d_sizes, d_rcoff, d_wlocs, d_clocs, d_tags,
              d_sites, d_site_off, d_tag_off, packed)


class ShardedDeviceEngine(DeviceEngine):
    """DeviceEngine scaled over a mesh: stripes of reads per device.

    The base class's optimistic-chunk orchestration is reused; only the
    dispatch differs: a chunk of ``ndev * B_loc`` reads is laid out
    device-major and aligned under ``shard_map``.  Candidate capacity is
    PER STRIPE: the ok/overflow bits are computed inside the shard_map
    against the per-device capacity, so the base class's per-read overflow
    retry works unchanged."""

    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param,
                 mesh: Mesh | None = None, b_loc: int | None = None,
                 cands_loc: int | None = None):
        super().__init__(genome, index, param)
        from .mesh import make_mesh
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.ndev = self.mesh.devices.size
        from ..engine import device_engine as de
        self.B_loc = b_loc if b_loc is not None else de.DEV_BATCH
        self.C_loc = (cands_loc if cands_loc is not None
                      else de.CANDS_PER_READ * self.B_loc)
        # global chunk shape seen by the base-class orchestration
        self.B = self.ndev * self.B_loc
        if cands_loc is not None:
            self.cands_tiers = [self.C_loc]    # explicit capacity: one tier
            self.CANDS = self.CANDS_BIG = self.C_loc
        else:
            self._set_tiers(self.B_loc)        # capacity is PER STRIPE
            self.C_loc = self.CANDS
        rep = NamedSharding(self.mesh, P())
        # replicate the genome + index over every device in the mesh
        for name in ("d_catcat", "d_anchors", "d_sizes", "d_rcoff",
                     "d_wlocs", "d_clocs", "d_tags", "d_sites", "d_site_off",
                     "d_tag_off", "d_kmer_tab", "prof_a",
                     "rc_code", "rc_n_code"):
            setattr(self, name, jax.device_put(getattr(self, name), rep))
        self._shd = NamedSharding(self.mesh, P(self.axis))
        self.last_n_aligned = 0
        self._probe_ok = False    # _sharded_fused reads result columns

    def _dispatch(self, cfg, packed, cands: int | None = None):
        placed = jax.device_put(packed, self._shd)
        out, n_aligned = _sharded_fused(
            cfg, self.C_loc if cands is None else cands,
            self.mesh, self.axis, self.prof_a,
            self.d_kmer_tab, self.rc_code, self.rc_n_code,
            self.d_catcat, self.d_anchors, self.d_sizes, self.d_rcoff,
            self.d_wlocs, self.d_clocs, self.d_tags, self.d_sites,
            self.d_site_off, self.d_tag_off, placed)
        self.last_n_aligned = n_aligned
        return out

