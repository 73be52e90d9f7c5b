"""Index-sharded alignment over a device mesh (SURVEY.md §7 phase B).

The reference keeps ONE copy of the seed index in RAM shared by threads
(/root/reference/dbseq.cpp:308-539, ~9 GB for human at -I 4,
README.txt:76-77).  Here the index — the dominant memory consumer — is
SHARDED across the mesh by genome region, and every device scans the same
(replicated) read window against its shard:

  * Watson entries are owned by the region of their Watson coordinate;
    Crick entries by the region of their Watson-PROJECTED coordinate
    (anchors[c] + rc_off[c] - crick_loc).  Within a bucket, entries ascend
    in coordinate, so each device's shard is a contiguous slice of every
    bucket's Watson run and Crick run — discovery order is preserved and
    reconstructible globally.
  * The per-bucket COUNT table is replicated (two int32 columns; tiny next
    to the locs) so every device computes the identical frequency-adaptive
    seed schedule (ReorderSeed, align.cpp:454-577).
  * The kernel (device_engine._verify_impl with cfg.shard_axis set) merges
    with XLA collectives (NCCL on GPUs): pmin for the progressive-sensitivity
    early exit, psum for the exact per-level hit histograms (UM/MA/OF and
    BSP columns stay bit-exact), and a per-slot all_gather that
    reconstructs each candidate's GLOBAL discovery rank so the reproducible
    myrand multi-hit selection picks the same hit the single-device engine
    would.
  * Same-dedup-key candidates are co-located by the region ownership, so
    first-discovery-wins dedup is local; the only exception — a key within
    one read length of a region boundary — raises the replay bit and the
    read runs on the exact host engine (span is <= FIXSIZE bases per
    boundary: vanishing fraction).

Memory at hg38 scale, 8 devices (arithmetic from array sizes, not
measured): locs ~12 GB / 8 = 1.5 GB/device sharded; genome catcat ~1.6 GB
and count table ~0.35 GB replicated.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.device_engine import (Cfg, DeviceEngine, EngineUnsupported,
                                    _align_fused_kernel)
from ..index import SeedIndex
from ..params import FIXSIZE, Param
from ..reference import PackedGenome


def build_region_shards(genome: PackedGenome, index: SeedIndex, ndev: int):
    """Split the WGBS CSR index into ndev region shards.

    Returns (bounds[ndev+1] uint32, kmer_tab[ndev, tk, 6] int32,
    wlocs[ndev, Lw] uint32, clocs[ndev, Lc] uint32) where each bucket row is
    [local_w_off, GLOBAL_total, local_w_cnt, local_c_off, local_c_cnt, 0].
    """
    tk = index.total_kmers
    counts = np.diff(index.offsets).astype(np.int64)
    wc = index.wcounts.astype(np.int64)
    cc = counts - wc
    anchors = genome.anchors[: genome.n_chr].astype(np.uint64)
    rcoff = genome.rc_offsets.astype(np.uint64)
    top = int(anchors[-1]) + int(rcoff[-1]) + FIXSIZE + 1
    bounds = np.linspace(0, top, ndev + 1).astype(np.uint64)
    bounds[0], bounds[-1] = 0, top

    # split locs by strand preserving in-bucket order (same construction as
    # DeviceEngine.__init__)
    total = len(index.locs)
    diff = np.zeros(total + 1, dtype=np.int8)
    nz = wc > 0
    np.add.at(diff, index.offsets[:-1][nz], 1)
    np.add.at(diff, (index.offsets[:-1] + wc)[nz], -1)
    is_w = np.cumsum(diff[:total], dtype=np.int8) > 0
    wl = index.locs[is_w].astype(np.uint64)
    cl = index.locs[~is_w].astype(np.uint64)
    bid_w = np.repeat(np.arange(tk, dtype=np.int64), wc)
    bid_c = np.repeat(np.arange(tk, dtype=np.int64), cc)

    # ownership regions
    reg_w = np.searchsorted(bounds, wl, side="right") - 1
    ci = np.searchsorted(anchors, cl, side="right") - 1
    y = anchors[ci] + rcoff[ci] - (cl - anchors[ci])
    reg_c = np.searchsorted(bounds, y, side="right") - 1

    tabs, wls, cls = [], [], []
    for d in range(ndev):
        tab = np.zeros((tk, 6), dtype=np.int32)
        tab[:, 1] = counts                       # global (schedule cost)
        lw = wl[reg_w == d]
        lwc = np.bincount(bid_w[reg_w == d], minlength=tk).astype(np.int64)
        lc = cl[reg_c == d]
        lcc = np.bincount(bid_c[reg_c == d], minlength=tk).astype(np.int64)
        tab[1:, 0] = np.cumsum(lwc[:-1])
        tab[:, 2] = lwc
        tab[1:, 3] = np.cumsum(lcc[:-1])
        tab[:, 4] = lwc + lcc
        tab[:, 5] = lcc
        tabs.append(tab)
        wls.append(lw.astype(np.uint32))
        cls.append(lc.astype(np.uint32))
    lmax_w = max(1, max(len(a) for a in wls))
    lmax_c = max(1, max(len(a) for a in cls))
    wl_s = np.zeros((ndev, lmax_w), dtype=np.uint32)
    cl_s = np.zeros((ndev, lmax_c), dtype=np.uint32)
    for d in range(ndev):
        wl_s[d, : len(wls[d])] = wls[d]
        cl_s[d, : len(cls[d])] = cls[d]
    return (bounds.astype(np.uint32), np.stack(tabs), wl_s, cl_s)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "cands", "mesh", "axis"))
def _index_sharded_call(cfg: Cfg, cands: int, mesh: Mesh, axis: str,
                        prof_a, d_kmer_tab, rc_code, rc_n_code,
                        d_catcat, d_anchors, d_sizes, d_rcoff, d_wlocs,
                        d_clocs, d_tags, d_sites, d_site_off, d_tag_off,
                        packed, bounds):
    """shard_map over the index-region axis: reads replicated, index
    sharded; the fused kernel's collectives (cfg.shard_axis) produce
    device-invariant full result rows."""

    def step(prof_a, kt, rc_code, rc_n_code, catcat, anchors, sizes,
             rcoff, wl, cl, tags, sites, soff, toff, pk, bnds):
        out = _align_fused_kernel(
            cfg, cands, prof_a, kt[0], rc_code, rc_n_code, catcat,
            anchors, sizes, rcoff, wl[0], cl[0], tags, sites, soff, toff,
            pk, bounds=bnds)
        return out[None]

    rep, shd = P(), P(axis)
    fn = jax.shard_map(step, mesh=mesh,
                       in_specs=(rep, shd, rep, rep, rep, rep, rep, rep,
                                 shd, shd, rep, rep, rep, rep, rep, rep),
                       out_specs=shd, check_vma=False)
    out = fn(prof_a, d_kmer_tab, rc_code, rc_n_code, d_catcat,
             d_anchors, d_sizes, d_rcoff, d_wlocs, d_clocs, d_tags,
             d_sites, d_site_off, d_tag_off, packed, bounds)
    return out[0]        # rows are device-invariant after the merges


class IndexShardedEngine(DeviceEngine):
    """DeviceEngine whose seed index is region-sharded across the mesh.

    The base class's batch orchestration (windowing, capacity escalation,
    exact host replay with MateState maintenance, block fast path) is
    inherited unchanged — only the table placement and the dispatch
    differ.  Capacity (CANDS) is PER DEVICE SHARD: the ok/big bits are
    all-device merges computed in-kernel."""

    def __init__(self, genome: PackedGenome, index: SeedIndex, param: Param,
                 mesh: Mesh | None = None, b_loc: int | None = None,
                 cands_loc: int | None = None):
        if param.RRBS_flag:
            raise EngineUnsupported("index-sharded engine: RRBS uses the "
                                    "single-device or host engines")
        super().__init__(genome, index, param)
        from .mesh import make_mesh
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.ndev = self.mesh.devices.size
        if b_loc is not None:
            self.B = b_loc
        if cands_loc is not None:
            self.cands_tiers = [cands_loc]     # explicit capacity: one tier
            self.CANDS = self.CANDS_BIG = cands_loc
        else:
            self._set_tiers(self.B)            # per-device-shard capacity

        bounds, tabs, wl_s, cl_s = build_region_shards(genome, index,
                                                       self.ndev)
        rep = NamedSharding(self.mesh, P())
        shd = NamedSharding(self.mesh, P(self.axis))
        self.d_kmer_tab = jax.device_put(jnp.asarray(tabs), shd)
        self.d_wlocs = jax.device_put(jnp.asarray(wl_s), shd)
        self.d_clocs = jax.device_put(jnp.asarray(cl_s), shd)
        self.d_bounds = jax.device_put(jnp.asarray(bounds), rep)
        for name in ("d_catcat", "d_anchors", "d_sizes", "d_rcoff",
                     "d_tags", "d_sites", "d_site_off", "d_tag_off",
                     "prof_a", "rc_code", "rc_n_code"):
            setattr(self, name, jax.device_put(
                np.asarray(getattr(self, name)), rep))
        self._rep = rep

    def _cfg(self, chains_mode: str, lean: bool = False,
             nw: int | None = None) -> Cfg:
        # full rows only (the lean 2-int32 layout lacks the fields the
        # replay/state machinery reads); block path repacks to lean after
        kw = {} if nw is None else {"nw": nw}
        return super()._cfg(chains_mode, lean=False, **kw)._replace(
            shard_axis=self.axis)

    def _dispatch(self, cfg: Cfg, packed, cands: int | None = None):
        placed = jax.device_put(packed, self._rep)
        return _index_sharded_call(
            cfg, self.CANDS if cands is None else cands, self.mesh,
            self.axis, self.prof_a, self.d_kmer_tab,
            self.rc_code, self.rc_n_code, self.d_catcat, self.d_anchors,
            self.d_sizes, self.d_rcoff, self.d_wlocs, self.d_clocs,
            self.d_tags, self.d_sites, self.d_site_off, self.d_tag_off,
            placed, self.d_bounds)
