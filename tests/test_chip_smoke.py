"""chip_smoke.py's helpers on the CPU: the contract line, the refusal to run
without a GPU, and one phase at tiny size with the device check off.  The
full script runs on the card (``python chip_smoke.py``); the test marked
``chip`` runs only there."""

import json
import sys
from types import SimpleNamespace

import pytest

from .conftest import REPO, simulate

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _dev(platform, kind):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_contract_line_exact_keys():
    line = chip_smoke.contract_line([_dev("gpu", "NVIDIA H100 80GB HBM3")])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    four = json.loads(chip_smoke.contract_line([_dev("gpu", "H")] * 4))
    assert four == {"ok": True, "device": {"platform": "gpu", "kind": "H",
                                           "count": 4}}


def test_require_gpu_refuses_cpu():
    import jax
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError):
        chip_smoke.require_gpu([])
    chip_smoke.require_gpu([_dev("gpu", "H")])


def test_phase_tiny_on_cpu(tmp_path):
    simulate(tmp_path, genome_out="g.fa", reads_out="r.fq", n_reads=600,
             read_len=80, chr_len=30000, seed=71, error_rate=0.02)
    common = ["-a", str(tmp_path / "r.fq"), "-d", str(tmp_path / "g.fa"),
              "-S", "1", "-u", "-p", "1", "--engine", "device",
              "--index-cache", str(tmp_path / "index")]
    line = chip_smoke.run_phase(
        "tiny", common, lambda eng: eng.warmup_programs("f", 7, True),
        card="cpu", out_dir=str(tmp_path), expect_platform="cpu",
        n_parity=200)
    assert line["engine"] == "DeviceEngine"
    assert line["array_platform"] == ["cpu"]
    assert line["native_lib"] and line["block_path"]
    assert line["reads"] == 600
    assert line["parity"] == {"host_reads": 200, "records": 200,
                              "identical": True}
    assert line["compile_cold_s"] > 0 and line["compile_cached_s"] > 0


@pytest.mark.chip
def test_device_is_gpu():
    """On the card: JAX computes on the GPU (chip_smoke.py runs the rest)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py there")
    chip_smoke.require_gpu(jax.devices())
