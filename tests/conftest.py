"""Test configuration: force JAX onto a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without a GPU.  Tests that need
the card carry the ``chip`` marker and skip here."""

import os

# Force CPU even when a GPU is present: the multi-device sharding tests
# need the virtual 8-device CPU mesh.  (jax may be imported before this
# file runs, so setting the env var alone is not enough — update the live
# config too.)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("BSMAP_JAX_DEV_BATCH", "2048")
os.environ.setdefault("BSMAP_JAX_CANDS_PER_READ", "16")
# short-lived CLI subprocesses with identical flags: let them share the
# flag-keyed XLA compile cache instead of recompiling per process
os.environ.setdefault("BSMAP_JAX_CPU_JIT_CACHE", "1")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8").strip()

import sys as _sys

if "jax" in _sys.modules:
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_SRC = pathlib.Path("/root/reference")
REF_DIR = pathlib.Path("/tmp/bsmap_ref")
REF_BUILD = REF_DIR / "bsmap"


def _build_reference() -> bool:
    """Compile the reference BSMAP out-of-repo (in /tmp) for golden-output
    comparisons.  Mirrors the reference makefile's flags (makefile:4) minus
    the vendored-samtools BAM input (stubbed: golden tests feed FASTA/FASTQ;
    BAM-input interop tests build libbam separately)."""
    if not (REF_SRC / "main.cpp").exists():
        return False
    REF_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [str(REF_SRC / f) for f in
            ("main.cpp", "align.cpp", "dbseq.cpp", "pairs.cpp", "param.cpp",
             "reads.cpp", "utilities.cpp")]
    cmd = ["g++", "-O3", "-funroll-loops", "-w", "-fpermissive",
           "-std=gnu++03", "-include", "unistd.h",
           "-DMAXHITS=1000", "-DTHREAD",
           "-DREAD_144", "-I", str(REF_SRC / "samtools"),
           "-o", str(REF_BUILD), *srcs,
           "-L", str(REF_SRC / "samtools"), "-lbam", "-lz", "-lpthread", "-lm"]
    if not (REF_SRC / "samtools" / "libbam.a").exists():
        # build libbam once, out-of-repo object dir
        objdir = REF_DIR / "samtools_obj"
        objdir.mkdir(exist_ok=True)
        cfiles = sorted((REF_SRC / "samtools").glob("*.c"))
        skip = {"main.c", "bamtk.c", "razip.c", "bgzip.c", "calDepth.c",
                "bam2bcf.c", "errmod.c", "sample.c"}
        objs = []
        for c in cfiles:
            if c.name in skip:
                continue
            o = objdir / (c.stem + ".o")
            if not o.exists():
                r = subprocess.run(
                    ["gcc", "-O2", "-fPIC", "-D_FILE_OFFSET_BITS=64",
                     "-D_USE_KNETFILE", "-I", str(REF_SRC / "samtools"),
                     "-c", str(c), "-o", str(o)], capture_output=True)
                if r.returncode != 0:
                    continue
            objs.append(str(o))
        subprocess.run(["ar", "rcs", str(objdir / "libbam.a"), *objs],
                       capture_output=True)
        cmd[cmd.index("-L") + 1] = str(objdir)
    r = subprocess.run(cmd, capture_output=True)
    return r.returncode == 0 and REF_BUILD.exists()


def ensure_methratio3() -> str | None:
    """Generate a Python-3 version of the reference methratio.py
    (methratio.py:1-154 is Python 2) for byte-parity comparisons.  The only
    py2-isms are print statements and xrange; converted textually so the
    counting logic is bit-identical to the reference's."""
    out = REF_DIR / "methratio3.py"
    if out.exists():
        return str(out)
    src_path = REF_SRC / "methratio.py"
    if not src_path.exists():
        return None
    REF_DIR.mkdir(parents=True, exist_ok=True)
    src = src_path.read_text()
    src = src.replace(
        "print >> sys.stderr, ''.join(['\\t' for i in xrange(nt)]"
        "+['@ ',time.asctime(),': ',txt])",
        "print(''.join(['\\t' for i in range(nt)]"
        "+['@ ',time.asctime(),': ',txt]), file=sys.stderr)")
    src = src.replace(
        "print 'total %d valid mappings, %d covered cytosines, "
        "average coverage: %.2f fold.' % (nmap, nc, float(nd)/nc)",
        "print('total %d valid mappings, %d covered cytosines, "
        "average coverage: %.2f fold.' % (nmap, nc, float(nd)/nc))")
    out.write_text(src)
    return str(out)


@pytest.fixture(scope="session")
def reference_binary():
    """The compiled reference BSMAP binary (built on demand, out-of-repo in
    /tmp) for golden-output comparisons."""
    if REF_BUILD.exists() or _build_reference():
        return str(REF_BUILD)
    pytest.skip("reference bsmap could not be built from /root/reference")


@pytest.fixture(scope="session")
def tmp_data(tmp_path_factory):
    return tmp_path_factory.mktemp("data")


def simulate(out_dir, **kw):
    """Run tools/simulate.py with kwargs."""
    args = [sys.executable, str(REPO / "tools" / "simulate.py")]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        if isinstance(v, bool):
            if v:
                args.append(flag)
        else:
            args.extend([flag, str(v)])
    subprocess.run(args, check=True, cwd=out_dir)
