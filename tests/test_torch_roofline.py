"""The port's Hopper roofline (``go_audio_resampler_tpu_torch/utils/
roofline.py``) against the JAX package's ``utils/roofline.py``.

Given the JAX package's TPU granules, the models equal the JAX functions
exactly; given the same peaks, ``analyze`` equals the JAX function apart
from the renamed label ('tensor_cores' for 'mxu').  ``device_peaks``
reads the card: the H100 names are known, an unknown card or none
raises.
"""

import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.utils import roofline as jr
from go_audio_resampler_tpu_torch.utils import roofline as tr

V5E = {"kind": "TPU v5 lite", "bf16_tflops": 197.0, "hbm_gbps": 819.0}
TPU_GRANULES = dict(p2_granule=128, k_granule=128)
BANDED = [
    ((160, 343, 147), {}),
    ((160, 343, 147), dict(nnz=31519)),
    ((256, 512, 256 * 44100 / 48001), {}),
    ((256, 512, 256), {}),
    ((160, 343, 147), dict(read_amp=343 / 147, bytes_elem=2)),
]
GENERAL = [
    dict(factor=2, pre_taps=293, poly_taps=28, num_phases=80, step_hi=147,
         block=2048, poly_cap=2230),
    dict(factor=2, pre_taps=65, poly_taps=12, num_phases=64, step_hi=41,
         block=512, poly_cap=700, tile=128),
]


def _label(bound: str) -> str:
    return bound.replace("mxu", "tensor_cores")


@pytest.mark.parametrize("args,kw", BANDED)
def test_banded_model_equals_jax(args, kw):
    """Every case of tests/test_roofline.py's banded model, at the TPU
    granules (the JAX defaults), equal key for key."""
    assert tr.banded_model(*args, **kw, **TPU_GRANULES) == \
        jr.banded_model(*args, **kw)


def test_banded_model_time_major_granule_equals_jax():
    """The time-major layout's granule of 8 (P2 on sublanes)."""
    assert tr.banded_model(160, 343, 147, p2_granule=8, k_granule=128) == \
        jr.banded_model(160, 343, 147, p2_granule=8)


def test_banded_model_live_plan():
    """The live CD -> DAT operator, as tests/test_roofline.py reads it,
    with the port's own operator functions: the same dims and non-zeros."""
    import importlib
    from go_audio_resampler_tpu_torch.engine import plan_engine
    from go_audio_resampler_tpu_torch.filterdesign import Quality
    osm = importlib.import_module(
        "go_audio_resampler_tpu_torch.engine.oneshot")
    r, _, ipx, _ = osm._fused_rational_matrix(
        plan_engine(44100.0, 48000.0, Quality.HIGH))
    rs, ipxs = osm.superframe(r, ipx)
    m = tr.banded_model(rs.shape[0], rs.shape[1], ipxs,
                        nnz=int(np.count_nonzero(rs)), **TPU_GRANULES)
    assert (m["p2"], m["wx"], m["ipx"]) == (160, 343, 147.0)
    assert m == jr.banded_model(160, 343, 147, nnz=int(np.count_nonzero(rs)))


def test_banded_model_hopper_tiles():
    """The port's defaults are its kernels' tiles: 80 columns of P2 and
    8 taps (TF32 k8) at 'highest', 16 at the bf16 tiers."""
    m = tr.banded_model(160, 343, 147)
    assert m["slots_per_in"] == pytest.approx(2 * 160 * 344 / 147)
    assert m["useful_frac_of_slots"] == pytest.approx(343 / 344)
    m16 = tr.banded_model(160, 343, 147, k_granule=tr.K_GRANULE["high"])
    assert m16["slots_per_in"] == pytest.approx(2 * 160 * 352 / 147)
    assert tr.K_GRANULE == {"highest": 8, "high": 16, "default": 16}
    assert tr.P2_GRANULE == 80


@pytest.mark.parametrize("kw", GENERAL)
def test_general_model_equals_jax(kw):
    assert tr.general_model(**kw, k_granule=128) == jr.general_model(**kw)


@pytest.mark.parametrize("msps,tier", [
    (20767.0, "highest"), (72428.0, "default"), (1000.0, "highest"),
    (10000.0, "high"), (10000.0, "default"),
])
@pytest.mark.parametrize("dims", [(160, 343, 147), (256, 512, 256)])
def test_analyze_equals_jax(msps, tier, dims):
    """Given the same peaks and model, every key equals the JAX one; the
    bound's label differs only by the rename (the four verdicts of
    tests/test_roofline.py are among these cases)."""
    m = jr.banded_model(*dims)
    got = tr.analyze(msps, m, tier=tier, peaks=V5E)
    want = jr.analyze(msps, m, tier=tier, peaks=V5E)
    assert {k: v for k, v in got.items() if k != "bound"} == \
        {k: v for k, v in want.items() if k != "bound"}
    assert got["bound"] == _label(want["bound"])


def test_analyze_verdicts():
    """tests/test_roofline.py's verdicts under the port's labels."""
    m = tr.banded_model(160, 343, 147, **TPU_GRANULES)
    assert tr.analyze(20767.0, m, peaks=V5E)["bound"] == \
        "tensor_cores(tile-padding)"
    assert tr.analyze(72428.0, m, "default", V5E)["bound"] == "hbm"
    assert tr.analyze(1000.0, m, peaks=V5E)["bound"] == "framing"
    clean = tr.banded_model(256, 512, 256, **TPU_GRANULES)
    assert tr.analyze(22000.0, clean, peaks=V5E)["bound"] == "tensor_cores"


def test_tier_passes_against_bf16_peak():
    """'highest' is three TF32 passes, each at half the bf16 rate: six
    bf16-pass equivalents, so 989 / 6 == 495 / 3 on an H100 SXM."""
    assert tr.TIER_PASSES == jr.TIER_PASSES == {"highest": 6, "high": 3,
                                                "default": 1}
    p = tr.peaks_of("NVIDIA H100 80GB HBM3")
    a = tr.analyze(1.0, tr.banded_model(160, 343, 147), peaks=p)
    assert a["eff_peak_tflops"] == round(989.0 / 6, 1)
    assert 989.0 / 6 == pytest.approx(p["tf32_tflops"] / 3, rel=2e-3)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989.0, 495.0, 67.0, 3350.0)),
    ("NVIDIA H100 PCIe", (756.0, 378.0, 51.0, 2000.0)),
])
def test_peaks_of_h100(name, peaks):
    p = tr.peaks_of(name, "700.00 W")
    assert (p["bf16_tflops"], p["tf32_tflops"], p["fp32_tflops"],
            p["hbm_gbps"]) == peaks
    assert p["kind"] == name and p["power_limit"] == "700.00 W"


def test_peaks_of_unknown_card_raises():
    with pytest.raises(KeyError, match="TPU v5 lite"):
        tr.peaks_of("TPU v5 lite")


def test_device_peaks_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.device_peaks()
    with pytest.raises(RuntimeError):
        tr.analyze(1.0, tr.banded_model(160, 343, 147))


def test_device_peaks_reads_the_card(monkeypatch):
    """The name from torch.cuda, the limit from nvidia-smi's line of that
    card; a card the table does not know raises and names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    names = {0: "NVIDIA H100 PCIe", 1: "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: names[i])
    monkeypatch.setattr(tr, "power_limit",
                        lambda i: ["350.00 W", "700.00 W"][i])
    p = tr.device_peaks()
    assert p["kind"] == names[1] and p["power_limit"] == "700.00 W"
    assert tr.device_peaks(0)["kind"] == names[0]
    assert tr.device_peaks("cuda:0")["power_limit"] == "350.00 W"
    names[1] = "NVIDIA A100-SXM4-80GB"
    with pytest.raises(KeyError, match="A100"):
        tr.device_peaks()
