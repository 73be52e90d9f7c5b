"""Seed index: base-3 kmer buckets over the packed genome (dbseq.cpp:308-539).

WGBS mode (C6): a CSR table over all 3^seed_size collapsed seeds.  For every
unmasked block, seeds are taken at positions == 0 (mod index_interval)
(dbseq.cpp:353,446 — note both loop bounds use *floor* division, so the first
probed position can precede the block start by up to interval-1 bases).
Bucket entry order must match the reference exactly (it determines hit
discovery order, hence multi-hit selection): all Watson blocks (even ids, in
(id, begin) order) first, then all Crick blocks (dbseq.cpp:441-480); entries
are global concatenated coordinates (hit2int: anchors[chr] + loc).

RRBS mode (C7): buckets hold (tag, loc) entries where tag packs
chr | (segment j << 16) | (rc_flag << 24) (dbseq.cpp:421-434) and loc is the
chr-local coordinate in that chromosome's own packed array.  Enumeration
order: j outer, chr inner, base entries then (if pairend/chains) rc entries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

from .encoding import seed_values, unpack_u32
from .params import Param, SEGLEN
from .reference import PackedGenome


@dataclasses.dataclass
class SeedIndex:
    seed_size: int
    rrbs: bool
    offsets: np.ndarray          # (3^S + 1,) int64 CSR row offsets
    locs: np.ndarray             # (total,) uint32 entry coordinates
    wcounts: np.ndarray | None   # (3^S,) int32 Watson-entry count (WGBS)
    tags: np.ndarray | None      # (total,) uint32 packed chr/j/rc (RRBS)

    @property
    def total_kmers(self) -> int:
        return 3 ** self.seed_size

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)


def _chr_codes(genome: PackedGenome, chr_idx: int, crick: bool) -> np.ndarray:
    """Unpack one chromosome's 2-bit codes from refcat/crefcat."""
    cat = genome.crefcat if crick else genome.refcat
    w0 = int(genome.anchors[chr_idx]) // SEGLEN
    n = int(genome.n_words[chr_idx])
    return unpack_u32(cat[w0: w0 + n])


def _csr_from(seeds: np.ndarray, payload: list[np.ndarray],
              total_kmers: int):
    """Stable-bucket the enumerated entries by seed value, preserving
    enumeration order within each bucket (matches the two-pass
    count-then-fill build: dbseq.cpp:327-514)."""
    order = np.argsort(seeds, kind="stable")
    counts = np.bincount(seeds, minlength=total_kmers)
    offsets = np.zeros(total_kmers + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, [p[order] for p in payload]


def _build_wgbs_native(genome: PackedGenome, param: Param, lib) -> SeedIndex:
    """Two-pass count/fill build in C (dbseq.cpp:327-514 pattern): O(n)
    time, and peak memory = the index itself + the count tables — the numpy
    global-argsort path peaks at several times that at human-genome scale."""
    S, I = param.seed_size, param.index_interval
    tk = 3 ** S
    # block enumeration order: Watson blocks in (id, begin) order, then
    # Crick (dbseq.cpp:441-480)
    rows = []
    for want_odd in (0, 1):
        for bid, begin, end in zip(genome.block_id, genome.block_begin,
                                   genome.block_end):
            if int(bid) % 2 != want_odd:
                continue
            rows.append((want_odd, int(bid) // 2, int(begin), int(end)))
    blocks = (np.asarray(rows, dtype=np.int64).reshape(-1, 4)
              if rows else np.zeros((0, 4), dtype=np.int64))
    chr_w0 = (genome.anchors[: genome.n_chr] // SEGLEN).astype(np.int64)
    anchors = genome.anchors[: genome.n_chr].astype(np.int64)
    counts = np.zeros(tk, dtype=np.uint32)
    wcounts = np.zeros(tk, dtype=np.uint32)
    refcat = np.ascontiguousarray(genome.refcat, dtype=np.uint32)
    crefcat = np.ascontiguousarray(genome.crefcat, dtype=np.uint32)
    empty_i64 = np.zeros(1, dtype=np.int64)
    empty_u32 = np.zeros(1, dtype=np.uint32)
    lib.bsmap_index_pass(refcat, crefcat, chr_w0, anchors,
                         blocks.reshape(-1), len(blocks), S, I, 1,
                         counts, wcounts, empty_i64, empty_i64, empty_u32)
    offsets = np.zeros(tk + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    locs = np.empty(int(offsets[-1]), dtype=np.uint32)
    cursors = np.zeros(tk, dtype=np.int64)
    lib.bsmap_index_pass(refcat, crefcat, chr_w0, anchors,
                         blocks.reshape(-1), len(blocks), S, I, 2,
                         counts, wcounts, offsets, cursors,
                         locs if len(locs) else empty_u32)
    return SeedIndex(seed_size=S, rrbs=False, offsets=offsets, locs=locs,
                     wcounts=wcounts.astype(np.int32), tags=None)


def build_index(genome: PackedGenome, param: Param) -> SeedIndex:
    S = param.seed_size
    I = param.index_interval
    tk = 3 ** S

    if not param.RRBS_flag:
        from . import native
        lib = native.get_lib()
        if lib is not None and os.environ.get("BSMAP_JAX_NATIVE_INDEX",
                                              "1") != "0":
            return _build_wgbs_native(genome, param, lib)
        # -- WGBS fallback: enumerate indexed positions per block ------------
        seeds_parts: list[np.ndarray] = []
        locs_parts: list[np.ndarray] = []
        parity_parts: list[np.ndarray] = []
        code_cache: dict[tuple[int, bool], np.ndarray] = {}
        seedval_cache: dict[tuple[int, bool], np.ndarray] = {}
        # Watson (even id) blocks first, then Crick — dbseq.cpp:441-480.
        for want_odd in (0, 1):
            for bid, begin, end in zip(genome.block_id, genome.block_begin,
                                       genome.block_end):
                if int(bid) % 2 != want_odd:
                    continue
                chr_idx, crick = int(bid) // 2, bool(bid % 2)
                key = (chr_idx, crick)
                if key not in seedval_cache:
                    codes = _chr_codes(genome, chr_idx, crick)
                    seedval_cache[key] = seed_values(codes, S)
                sv = seedval_cache[key]
                i0 = (int(begin) // I) * I
                i2 = ((int(end) - S) // I) * I
                if i2 < i0:
                    continue
                pos = np.arange(i0, i2 + 1, I, dtype=np.int64)
                seeds_parts.append(sv[pos])
                locs_parts.append(pos + int(genome.anchors[chr_idx]))
                parity_parts.append(
                    np.full(len(pos), want_odd, dtype=np.int8))
        if seeds_parts:
            all_seeds = np.concatenate(seeds_parts)
            all_locs = np.concatenate(locs_parts)
            all_par = np.concatenate(parity_parts)
        else:
            all_seeds = np.zeros(0, dtype=np.int64)
            all_locs = np.zeros(0, dtype=np.int64)
            all_par = np.zeros(0, dtype=np.int8)
        offsets, (locs_sorted, par_sorted) = _csr_from(
            all_seeds, [all_locs, all_par], tk)
        wcounts = np.bincount(all_seeds[all_par == 0],
                              minlength=tk).astype(np.int32)
        return SeedIndex(seed_size=S, rrbs=False, offsets=offsets,
                         locs=locs_sorted.astype(np.uint32),
                         wcounts=wcounts, tags=None)

    # -- RRBS: digestion-site constrained entries ----------------------------
    seeds_parts = []
    locs_parts = []
    tags_parts = []
    both = bool(param.pairend or param.chains)
    nseg = param.max_seedseg_num
    n2 = 2 * genome.n_chr
    sv_cache: dict[int, np.ndarray] = {}

    def seedvals(chr_packed: int) -> np.ndarray:
        if chr_packed not in sv_cache:
            codes = _chr_codes(genome, chr_packed // 2, bool(chr_packed % 2))
            sv_cache[chr_packed] = seed_values(codes, S)
        return sv_cache[chr_packed]

    for j in range(nseg):
        for chrp in range(n2):
            base_pos = genome.ccgg_index[j][chrp]
            if len(base_pos):
                sv = seedvals(chrp)
                seeds_parts.append(sv[base_pos])
                locs_parts.append(base_pos)
                tags_parts.append(np.full(len(base_pos),
                                          chrp | (j << 16), dtype=np.int64))
            if both:
                # rc side: positions of chr^1's list, mirrored into this
                # chromosome's own coordinates (dbseq.cpp:427-434)
                other = genome.ccgg_index[j][chrp ^ 1]
                if len(other):
                    tmp_offset = int(genome.rc_offsets[chrp // 2]) - S
                    pos = tmp_offset - other
                    sv = seedvals(chrp)
                    seeds_parts.append(sv[pos])
                    locs_parts.append(pos)
                    tags_parts.append(np.full(
                        len(pos), chrp | (j << 16) | 0x1000000,
                        dtype=np.int64))
    if seeds_parts:
        all_seeds = np.concatenate(seeds_parts)
        all_locs = np.concatenate(locs_parts)
        all_tags = np.concatenate(tags_parts)
    else:
        all_seeds = np.zeros(0, dtype=np.int64)
        all_locs = np.zeros(0, dtype=np.int64)
        all_tags = np.zeros(0, dtype=np.int64)
    offsets, (locs_sorted, tags_sorted) = _csr_from(
        all_seeds, [all_locs, all_tags], tk)
    return SeedIndex(seed_size=S, rrbs=True, offsets=offsets,
                     locs=locs_sorted.astype(np.uint32), wcounts=None,
                     tags=tags_sorted.astype(np.uint32))


# ---------------------------------------------------------------------------
# On-disk caching: the reference rebuilds its index on every run
# (main.cpp:457-464); we persist it keyed by genome + parameters instead
# (SURVEY.md section 5 "Checkpoint / resume").
# ---------------------------------------------------------------------------

def index_cache_key(fasta_path: str, param: Param) -> str:
    h = hashlib.sha256()
    st = os.stat(fasta_path)
    h.update(f"{os.path.abspath(fasta_path)}:{st.st_size}:{st.st_mtime_ns}"
             .encode())
    h.update(f"S{param.seed_size}:I{param.index_interval}:"
             f"M{param.read_nt}{param.ref_nt}:R{param.RRBS_flag}:"
             f"D{param.digest_site}@{param.digest_pos}:"
             f"x{param.max_insert}:pe{int(bool(param.pairend or param.chains))}"
             .encode())
    return h.hexdigest()[:24]


def save_index(path: str, idx: SeedIndex) -> None:
    # uncompressed (ZIP_STORED) so load_index(mmap=True) can memory-map the
    # members in place: N local -p workers then share ONE page-cached copy
    # (the reference's threads share one in-RAM index, main.cpp:45-131)
    np.savez(
        path, seed_size=idx.seed_size, rrbs=int(idx.rrbs),
        offsets=idx.offsets, locs=idx.locs,
        wcounts=idx.wcounts if idx.wcounts is not None else np.zeros(0),
        tags=idx.tags if idx.tags is not None else np.zeros(0))


# public .npy header readers by format version (others load in full)
_NPY_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}


def _mmap_npz(path: str) -> dict:
    """Memory-map every stored (uncompressed) member of an .npz in place."""
    import zipfile
    import struct
    out = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError("compressed npz member; rebuild the cache")
            with open(path, "rb") as fh:
                fh.seek(info.header_offset)
                hdr = fh.read(30)
                name_len, extra_len = struct.unpack("<HH", hdr[26:30])
                data_off = info.header_offset + 30 + name_len + extra_len
                fh.seek(data_off)
                version = np.lib.format.read_magic(fh)
                read_header = _NPY_HEADER_READERS.get(version)
                if read_header is not None:
                    shape, fortran, dtype = read_header(fh)
                arr_off = fh.tell()
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if read_header is None or fortran or 0 in shape or not shape \
                    or dtype.hasobject or dtype.kind in "US":
                out[name] = np.load(path)[name]
            else:
                out[name] = np.memmap(path, dtype=dtype, mode="r",
                                      offset=arr_off, shape=shape)
    return out


def load_index(path: str, mmap: bool = False) -> SeedIndex:
    z = _mmap_npz(path) if mmap else np.load(path)
    rrbs = bool(int(z["rrbs"]))
    return SeedIndex(
        seed_size=int(z["seed_size"]), rrbs=rrbs,
        offsets=np.asarray(z["offsets"]) if not mmap else z["offsets"],
        locs=z["locs"],
        wcounts=None if rrbs else z["wcounts"],
        tags=z["tags"] if rrbs else None)
