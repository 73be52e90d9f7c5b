"""ctypes bindings for the native host runtime (bsmap_native.cpp).

The shared library is compiled on demand with g++ (the toolchain the
reference itself requires, makefile:1-30) and cached next to the source,
keyed by a hash of the source text: a library built from any other version
of bsmap_native.cpp is never loaded.  When the build fails the compiler's
message goes to stderr, every entry point returns None and callers take
the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bsmap_native.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_u8 = ctypes.c_uint8
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def so_path(src: str = _SRC) -> str:
    """Built-library path for this source text (content hash, not mtime)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(os.path.dirname(src), f"_bsmap_native.{digest}.so")


def _build(so: str) -> bool:
    # per-process temp name: concurrent workers may build at once
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except OSError as e:
        print(f"native library build failed: {e}", file=sys.stderr)
        return False
    except subprocess.CalledProcessError as e:
        print("native library build failed:\n"
              + e.stderr.decode(errors="replace"), file=sys.stderr)
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> ctypes.CDLL | None:
    """Compile (if absent) and load the native library; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.bsmap_parse_reads.restype = _i64
        lib.bsmap_parse_reads.argtypes = [
            ctypes.c_char_p, _i64, _i32, _i32, _i64, _i64, _p_i64,
            ctypes.POINTER(_i64)]
        lib.bsmap_encode_block.restype = None
        lib.bsmap_encode_block.argtypes = [
            ctypes.c_char_p, _p_i64, _i64, _p_u8, _p_u8, _i64,
            _p_u8, _p_u8, _p_i32, _p_i32]
        lib.bsmap_encode_block_words.restype = None
        lib.bsmap_encode_block_words.argtypes = [
            ctypes.c_char_p, _p_i64, _i64, _p_u8, _p_u8, _i64, _p_i32]
        lib.bsmap_index_pass.restype = None
        lib.bsmap_index_pass.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _p_i64, _p_i64, _p_i64, _i64, _i64, _i64, _i32,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            _p_i64, _p_i64,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")]
        lib.bsmap_format_sam_block.restype = _i64
        lib.bsmap_format_sam_block.argtypes = [
            ctypes.c_char_p, _p_i64, _i64, _p_i32, _p_i32,
            _p_u8, _p_i64, _p_u8, _i32, _i32, _i32, _u8,
            _i32, _p_i64, _p_i64, _i64, _p_u8, _i64,
            _p_i64, ctypes.POINTER(_i64)]
        lib.bsmap_filter_block.restype = None
        lib.bsmap_filter_block.argtypes = [
            _p_u8, _p_i64, _i64, ctypes.c_char_p, _p_i64, _i64, _i32,
            ctypes.c_char_p, _i64, _i32, _i64, _i32, _i32, _i32, _i64,
            _i64, _i64, _u8, _p_u8, _p_i32]
        _p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.bsmap_format_sam_block_xr.restype = _i64
        lib.bsmap_format_sam_block_xr.argtypes = [
            ctypes.c_char_p, _p_i64, _i64, _p_i32, _p_i32,
            _p_u8, _p_i64, _p_u8, _i32, _i32, _i32, _u8,
            _i32, _p_u32, _i64, _p_i64, ctypes.c_char_p, _p_u8,
            _i32, _p_i64, _p_i64, _i64,
            _p_u8, _i64, _p_i64, ctypes.POINTER(_i64)]
        lib.bsmap_fix_pair_names.restype = _i64
        lib.bsmap_fix_pair_names.argtypes = [
            ctypes.c_char_p, _p_i64, ctypes.c_char_p, _p_i64, _i64]
        lib.bsmap_format_pair_block.restype = _i64
        lib.bsmap_format_pair_block.argtypes = [
            ctypes.c_char_p, _p_i64, ctypes.c_char_p, _p_i64, _i64,
            _p_i32, _p_i32, _p_u8, _p_i64, _p_u8, _i32, _i32, _u8, _u8,
            _p_u8, _i64, _p_i64, _p_i64]
        lib.bsmap_format_bsp_block.restype = _i64
        lib.bsmap_format_bsp_block.argtypes = [
            ctypes.c_char_p, _p_i64, _i64, _p_i32, _p_i32, _i64, _i64,
            _p_u8, _p_i64, _p_u8, _i32, _i32, _i32, _i32, _u8,
            _p_u32, _i64, _p_i64, ctypes.c_char_p, _p_u8, _p_i32,
            _p_u8, _i64, _p_i64, ctypes.POINTER(_i64)]
        _LIB = lib
        return _LIB


def parse_reads(lib, buf: bytes, is_final: bool, is_fasta: bool,
                max_readlen: int, cap: int):
    """Parse up to cap reads out of buf; returns (rec[n,6], consumed)."""
    rec = np.empty((cap, 6), dtype=np.int64)
    consumed = _i64(0)
    n = lib.bsmap_parse_reads(buf, len(buf), int(is_final), int(is_fasta),
                              max_readlen, cap, rec.reshape(-1),
                              ctypes.byref(consumed))
    return rec[:n], int(consumed.value)


def encode_block(lib, buf: bytes, rec: np.ndarray, alphabet: np.ndarray,
                 reg_alphabet: np.ndarray, fixsize: int):
    """(codes, regs, lens, n_counts) for a parsed block."""
    n = len(rec)
    codes = np.zeros((n, fixsize), dtype=np.uint8)
    regs = np.zeros((n, fixsize), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    ncnt = np.zeros(n, dtype=np.int32)
    lib.bsmap_encode_block(buf, np.ascontiguousarray(rec).reshape(-1), n,
                           np.ascontiguousarray(alphabet),
                           np.ascontiguousarray(reg_alphabet), fixsize,
                           codes.reshape(-1), regs.reshape(-1), lens, ncnt)
    return codes, regs, lens, ncnt


def encode_block_words(lib, buf: bytes, rec: np.ndarray, alphabet: np.ndarray,
                       reg_alphabet: np.ndarray, nwords: int):
    """Device dispatch rows (n, 2*nwords+4) int32 for a parsed block:
    [qwords | rwords | len | 0 | 0 | ncnt]; see bsmap_encode_block_words."""
    n = len(rec)
    rows = np.zeros((n, 2 * nwords + 4), dtype=np.int32)
    lib.bsmap_encode_block_words(buf, np.ascontiguousarray(rec).reshape(-1),
                                 n, np.ascontiguousarray(alphabet),
                                 np.ascontiguousarray(reg_alphabet), nwords,
                                 rows.reshape(-1))
    return rows


def format_sam_block_xr(lib, buf: bytes, rec: np.ndarray, status: np.ndarray,
                        rows: np.ndarray, chrnames: np.ndarray,
                        chrname_off: np.ndarray, revc: np.ndarray,
                        flag_base: int, out_unmap: bool, rrhits: int,
                        synth_qual: int, refcat: np.ndarray,
                        total_codes: int, anchors: np.ndarray,
                        useful_nt: bytes, mapseq: np.ndarray,
                        rrbs: int = 0, rr_sites: np.ndarray | None = None,
                        rr_site_off: np.ndarray | None = None,
                        rr_tail: int = 0):
    """SAM block with XR:Z: context tags (-R) and optional RRBS ZP/ZL tags;
    mapseq is the caller-held persistent 256-byte context buffer
    (stale-slot quirk)."""
    n = len(rec)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    if rr_sites is None:
        rr_sites = np.zeros(1, dtype=np.int64)
    if rr_site_off is None:
        rr_site_off = np.zeros(2, dtype=np.int64)
    cap = int(rec[:, 1].sum() + 3 * rec[:, 3].sum() + rec[:, 5].sum()
              + 192 * n + 4096)
    line_off = np.zeros(n + 1, dtype=np.int64)
    na = _i64(0)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        w = lib.bsmap_format_sam_block_xr(
            buf, np.ascontiguousarray(rec).reshape(-1), n,
            np.ascontiguousarray(status, dtype=np.int32),
            rows.reshape(-1), chrnames, chrname_off, revc, flag_base,
            int(out_unmap), rrhits, synth_qual, 1,
            np.ascontiguousarray(refcat, dtype=np.uint32), total_codes,
            np.ascontiguousarray(anchors, dtype=np.int64), useful_nt,
            mapseq, int(rrbs),
            np.ascontiguousarray(rr_sites, dtype=np.int64),
            np.ascontiguousarray(rr_site_off, dtype=np.int64), rr_tail,
            out, cap, line_off, ctypes.byref(na))
        if w >= 0:
            return out[:w].data, line_off, int(na.value)
        cap *= 2


def format_bsp_block(lib, buf: bytes, rec: np.ndarray, status: np.ndarray,
                     rows: np.ndarray, maxseg: int, chrnames: np.ndarray,
                     chrname_off: np.ndarray, revc: np.ndarray,
                     out_unmap: bool, rrhits: int, max_snp_num: int,
                     max_num_hits: int, synth_qual: int, refcat: np.ndarray,
                     total_codes: int, anchors: np.ndarray,
                     useful_nt: bytes, mapseq: np.ndarray,
                     budgets: np.ndarray):
    """BSP block (align.cpp:723-760); rows are FULL kernel result rows
    including synthesized rows for replayed reads; budgets are the per-read
    post-trim read_max_snp_num values (histogram width)."""
    n = len(rec)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cap = int(rec[:, 1].sum() + 3 * rec[:, 3].sum() + rec[:, 5].sum()
              + 256 * n + 4096)
    line_off = np.zeros(n + 1, dtype=np.int64)
    na = _i64(0)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        w = lib.bsmap_format_bsp_block(
            buf, np.ascontiguousarray(rec).reshape(-1), n,
            np.ascontiguousarray(status, dtype=np.int32),
            rows.reshape(-1), rows.shape[1], maxseg,
            chrnames, chrname_off, revc, int(out_unmap), rrhits,
            max_snp_num, max_num_hits, synth_qual,
            np.ascontiguousarray(refcat, dtype=np.uint32), total_codes,
            np.ascontiguousarray(anchors, dtype=np.int64), useful_nt,
            mapseq, np.ascontiguousarray(budgets, dtype=np.int32),
            out, cap, line_off, ctypes.byref(na))
        if w >= 0:
            return out[:w].data, line_off, int(na.value)
        cap *= 2


def filter_block(lib, buf: np.ndarray, rec: np.ndarray, p,
                 synth_qual: int) -> np.ndarray:
    """Native FilterReads over a parsed block: mutates rec (trim truncation)
    and, under the -z SAM rescale quirk, the quality bytes of `buf` (callers
    pass a writable copy exactly then).  Returns (n, 3) int32
    [filtered, budget, raw_len]."""
    from ..params import REG_ALPHABET
    n = len(rec)
    ad_bytes = b"".join(a.encode("latin1") for a in p.adapters)
    ad_off = np.zeros(len(p.adapters) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in p.adapters], out=ad_off[1:])
    prefix = (p.digest_site[: len(p.digest_site) - p.digest_pos]
              if p.RRBS_flag else "")
    info = np.zeros((n, 3), dtype=np.int32)
    lib.bsmap_filter_block(
        buf, rec.reshape(-1), n,
        ad_bytes, ad_off, len(p.adapters), int(p.RRBS_flag),
        prefix.encode("latin1"), len(prefix), int(p.pairend),
        p.seed_size, p.qual_threshold, p.zero_qual, int(bool(p.out_sam)),
        p.min_read_size, p.max_ns, p.max_snp_num, synth_qual,
        np.ascontiguousarray(REG_ALPHABET), info.reshape(-1))
    return info


def fix_pair_names(lib, bufa: bytes, reca: np.ndarray, bufb: bytes,
                   recb: np.ndarray) -> int:
    """FixPairReadName over both rec tables (mutates name_len columns).
    Returns -1, or the index of the first pair with no common prefix."""
    return int(lib.bsmap_fix_pair_names(bufa, reca.reshape(-1), bufb,
                                        recb.reshape(-1), len(reca)))


def format_pair_block(lib, bufa: bytes, reca: np.ndarray, bufb: bytes,
                      recb: np.ndarray, status: np.ndarray, prow: np.ndarray,
                      chrnames: np.ndarray, chrname_off: np.ndarray,
                      revc: np.ndarray, out_unmap: bool, rrhits: int,
                      synth_a: int, synth_b: int):
    """PE SAM block (pairs.cpp:288-498).  Returns (bytes_view, line_off,
    (n_pairs, n_a, n_b))."""
    n = len(reca)
    prow = np.ascontiguousarray(prow, dtype=np.int32)
    cap = int(reca[:, 1].sum() + recb[:, 1].sum()
              + 3 * (reca[:, 3].sum() + recb[:, 3].sum())
              + reca[:, 5].sum() + recb[:, 5].sum() + 256 * n + 4096)
    line_off = np.zeros(n + 1, dtype=np.int64)
    while True:
        counters = np.zeros(3, dtype=np.int64)
        out = np.empty(cap, dtype=np.uint8)
        w = lib.bsmap_format_pair_block(
            bufa, np.ascontiguousarray(reca).reshape(-1),
            bufb, np.ascontiguousarray(recb).reshape(-1), n,
            np.ascontiguousarray(status, dtype=np.int32),
            prow.reshape(-1), chrnames, chrname_off, revc,
            int(out_unmap), rrhits, synth_a, synth_b,
            out, cap, line_off, counters)
        if w >= 0:
            return (out[:w].data, line_off,
                    (int(counters[0]), int(counters[1]), int(counters[2])))
        cap *= 2


def format_sam_block(lib, buf: bytes, rec: np.ndarray, status: np.ndarray,
                     rows: np.ndarray, chrnames: np.ndarray,
                     chrname_off: np.ndarray, revc: np.ndarray,
                     flag_base: int, out_unmap: bool, rrhits: int,
                     synth_qual: int, rrbs: int = 0,
                     rr_sites: np.ndarray | None = None,
                     rr_site_off: np.ndarray | None = None,
                     rr_tail: int = 0):
    """Returns (bytes, line_off[n+1], n_aligned); rows are (n, 2) lean."""
    n = len(rec)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    if rr_sites is None:
        rr_sites = np.zeros(1, dtype=np.int64)
    if rr_site_off is None:
        rr_site_off = np.zeros(2, dtype=np.int64)
    cap = int(rec[:, 1].sum() + 2 * rec[:, 3].sum() + rec[:, 5].sum()
              + 128 * n + 4096)
    line_off = np.zeros(n + 1, dtype=np.int64)
    na = _i64(0)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        w = lib.bsmap_format_sam_block(
            buf, np.ascontiguousarray(rec).reshape(-1), n,
            np.ascontiguousarray(status, dtype=np.int32),
            rows.reshape(-1), chrnames, chrname_off,
            revc, flag_base, int(out_unmap), rrhits, synth_qual,
            int(rrbs), np.ascontiguousarray(rr_sites, dtype=np.int64),
            np.ascontiguousarray(rr_site_off, dtype=np.int64), rr_tail,
            out, cap, line_off, ctypes.byref(na))
        if w >= 0:
            # zero-copy view: callers write it or b"".join it directly
            return out[:w].data, line_off, int(na.value)
        cap *= 2
