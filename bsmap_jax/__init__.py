"""bsmap_jax — a batched JAX bisulfite short-read aligner.

A from-scratch JAX/XLA reimplementation of the capabilities of BSMAP v2.6
(the classic C++ bisulfite mapper): asymmetric C->T-aware ungapped
alignment of WGBS/RRBS reads against the four converted reference strands
(BSW/BSWC/BSC/BSCC), single- and pair-end mapping, adapter/quality trimming,
unique/random multi-hit reporting with reproducible selection, SAM/BSP output,
and downstream per-cytosine methylation-ratio calling.

Architecture:
  * packed 2-bit genome + base-3 seed CSR index, device resident
    (replicated or sharded over a jax.sharding.Mesh)
  * batched reads verified by a vectorized bitwise XOR/popcount extension
    over (reads x candidate-loci), compiled by XLA
  * an exact host "oracle" engine replicates the reference's sequential
    control flow for the rare reads where bucket caps / repeat-abort
    semantics matter, guaranteeing bit-identical output.

Reference semantics are cited throughout as ``file:line`` into the BSMAP
source tree (e.g. ``align.cpp:168``) so parity can be audited.
"""

import os as _os

import jax as _jax

# The device compute path is pure 32-bit integer math.  64-bit math — genome
# coordinates during index build, the reproducible xorshift myrand hash
# (utilities.cpp:40-50) — lives host-side in numpy, which is independent of
# this flag.
_jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: kernel shapes are stable across runs, so a
# compile is paid once per machine.  JAX_COMPILATION_CACHE_DIR, when set, is
# read by JAX itself and wins.  Otherwise the cache lives at a fixed path in
# the checkout, so every process of every run looks in the same place.
# Not on CPU by default: XLA's CPU AOT results are machine-feature-pinned
# (different XLA flags across processes change the pin set and reloading
# warns of possible SIGILL).  Test subprocesses opt in with
# BSMAP_JAX_CPU_JIT_CACHE=1 — they run many short-lived CLI processes with
# IDENTICAL flags, so the cache is safe there; the directory is suffixed
# with a hash of the XLA flags so differently-pinned entries never mix.
REPO_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def default_cache_dir(env=None) -> str | None:
    """The in-checkout compile-cache directory for this environment, or
    None where the cache stays off (CPU without the opt-in)."""
    env = _os.environ if env is None else env
    is_cpu = env.get("JAX_PLATFORMS", "").startswith("cpu")
    if is_cpu and env.get("BSMAP_JAX_CPU_JIT_CACHE") != "1":
        return None
    path = _os.path.join(REPO_DIR, ".jax_cache")
    if is_cpu:
        import hashlib
        tag = hashlib.sha1(env.get("XLA_FLAGS", "").encode()).hexdigest()[:10]
        path += "_cpu_" + tag
    return path


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = default_cache_dir()
    if _cache_dir is not None:
        _os.makedirs(_cache_dir, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)

__version__ = "0.1.0"
