"""PyTorch port vs JAX package: the one-shot entry point and K3.

The port's ``oneshot`` runs on ``device='cpu'`` (its kernels' plain
versions) against the JAX ``oneshot`` on the CPU, both fed the same numpy
inputs: float64 to 1e-12, float32 to 2e-5, identical lengths.  The host
builders (``_decim_matrix``, ``_general_matrices``, ``_cubic_matrices``,
the band matrix) must be bit-equal.  K3's plain version is held against
the JAX package's Pallas kernel in interpret mode; the CUDA kernels run
only on the card (``test_torch_cuda.py``).
"""

import importlib
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_audio_resampler_tpu.engine import stages as jstages
from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.ops import convolve as jconvolve
from go_audio_resampler_tpu.ops import pallas_fused as pf
import go_audio_resampler_tpu_torch as gart
from go_audio_resampler_tpu_torch.engine import plan_from_arrays
from go_audio_resampler_tpu_torch.engine import stages as tstages
from go_audio_resampler_tpu_torch.engine.plan import plan_engine
from go_audio_resampler_tpu_torch.filterdesign import Quality
from go_audio_resampler_tpu_torch.ops import convolve as tconvolve
from go_audio_resampler_tpu_torch.ops import fused, general

# Both packages' engine/__init__ re-export the function oneshot under the
# module's name.
joneshot = importlib.import_module("go_audio_resampler_tpu.engine.oneshot")
toneshot = importlib.import_module(
    "go_audio_resampler_tpu_torch.engine.oneshot")

TOL = {np.float32: 2e-5, np.float64: 1e-12}
#: One plan of every topology the port's one-shot runs, by name.
TOPOLOGIES = {
    "rational": (44100, 48000, 3, {}),
    "rational_down": (48000, 44100, 3, {}),
    "decimate": (48000, 16000, 3, {}),
    "decimate_vhq": (96000, 48000, 4, {}),
    "dft_up": (48000, 96000, 3, {}),
    "dft_up_unity": (48000, 48000, 3, {}),
    "general": (44100, 48001, 3, {}),
    "general_hq": (44100, 48001, 3, {"hq_interp": True}),
    "cubic": (44100, 48000, 0, {}),
}


def _plans(rates_q):
    jp = jplan_engine(rates_q[0], rates_q[1], JQuality(rates_q[2]),
                      **rates_q[3])
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _both(rates_q, x, dtype):
    jp, tp = _plans(rates_q)
    yj = np.asarray(joneshot.oneshot(jp, jnp.asarray(x.astype(dtype))))
    yt = gart.oneshot(tp, x.astype(dtype), device="cpu")
    assert isinstance(yt, torch.Tensor) and yt.device.type == "cpu"
    return yj, yt.numpy(), tp


# -- the entry point -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_oneshot_matches_jax(name, dtype):
    rates_q = TOPOLOGIES[name]
    x = np.random.default_rng(1).normal(size=(2, 3000)) * 0.5
    yj, yt, tp = _both(rates_q, x, dtype)
    assert tp.kind == {"rational": "two_stage", "rational_down": "two_stage",
                       "general": "two_stage", "general_hq": "two_stage",
                       "decimate_vhq": "decimate", "dft_up_unity": "dft_up"
                       }.get(name, name)
    assert yt.dtype == dtype
    assert yt.shape == yj.shape == (2, tp.lengths.canonical(3000))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("n", [0, 1, 7, 300, 4411])
@pytest.mark.parametrize("name", ["rational", "decimate", "dft_up",
                                  "general", "cubic"])
def test_exact_lengths(name, n):
    x = np.random.default_rng(n).normal(size=(1, n))
    yj, yt, tp = _both(TOPOLOGIES[name], x, np.float64)
    assert yt.shape == yj.shape == (1, tp.lengths.canonical(n))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=TOL[np.float64])


def test_inputs_and_types():
    tp = plan_engine(44100, 48000, Quality.HIGH)
    x = np.random.default_rng(2).normal(size=(2, 500))
    y64 = gart.oneshot(tp, x, device="cpu")
    assert y64.dtype == torch.float64
    y32 = gart.oneshot(tp, torch.from_numpy(x), dtype=np.float32,
                       device="cpu")
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="streams, samples"):
        gart.oneshot(tp, x[0], device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        gart.oneshot(tp, x, dtype=np.int32, device="cpu")


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gart.oneshot(plan_engine(44100, 48000, Quality.HIGH),
                     np.zeros((1, 100)))


@pytest.mark.parametrize("rates,kw", [
    ((48000, 44099), {"strict_antialias": True}),   # general + aa
    ((48000, 44101), {"strict_antialias": True}),   # general + aa
])
def test_strict_antialias_raises(rates, kw, monkeypatch):
    """A non-exact plan's prefilter of FFT_CONV_MIN_TAPS taps or more runs
    through FFT overlap-save, as in the JAX package: with both packages'
    crossover lowered to this plan's taps, the one-shots agree to 1e-11
    (the FFT routes' float64 tolerance, tests/test_fftstage.py)."""
    jp, tp = _plans(rates + (3, kw))
    assert tp.aa_taps > 0 and tp.kind == "two_stage"
    assert not tp.is_rational_exact
    monkeypatch.setattr(toneshot, "FFT_CONV_MIN_TAPS", tp.aa_taps)
    monkeypatch.setattr(joneshot, "FFT_CONV_MIN_TAPS", tp.aa_taps)
    joneshot._oneshot_jit.clear_cache()
    try:
        x = np.random.default_rng(21).normal(size=(2, 1000))
        aux = toneshot._oneshot_aux(tp, 1000, torch.float64, "cpu",
                                    "highest")
        assert type(aux[4]).__name__ == "Spectrum"
        got = gart.oneshot(tp, x, device="cpu").numpy()
        want = np.asarray(joneshot.oneshot(jp, x, dtype=np.float64))
    finally:
        joneshot._oneshot_jit.clear_cache()
    assert got.shape == want.shape == (2, tp.lengths.canonical(1000))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_fft_decimation_raises(monkeypatch):
    """Decimation at DECIM_FFT_MIN_TAPS taps or more runs through FFT
    overlap-save: with both crossovers lowered, 48k -> 16k HIGH agrees
    with the JAX package's FFT route to 1e-11."""
    jp, tp = _plans((48000, 16000, 3, {}))
    monkeypatch.setattr(toneshot, "DECIM_FFT_MIN_TAPS", 1)
    monkeypatch.setattr(joneshot, "DECIM_FFT_MIN_TAPS", 1)
    joneshot._oneshot_jit.clear_cache()
    try:
        x = np.random.default_rng(22).normal(size=(2, 1000))
        got = gart.oneshot(tp, x, device="cpu").numpy()
        want = np.asarray(joneshot.oneshot(jp, x, dtype=np.float64))
    finally:
        joneshot._oneshot_jit.clear_cache()
    assert got.shape == want.shape == (2, tp.lengths.canonical(1000))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


@pytest.mark.parametrize("name,wrapper", [
    ("rational", "fused"), ("decimate", "fused"), ("dft_up", None),
    ("general", "general"), ("cubic", "general"),
])
def test_each_topology_goes_through_its_kernel(monkeypatch, name, wrapper):
    """Each topology reaches the wrapper of the kernel it runs on the card
    (K1: ops.fused, K3: ops.general), once per call.  On the CPU dft_up's
    prestage takes the frames lowering of ``ops/convolve.py``, which has
    no kernel; on the card it is the banded lowering, one K1 launch
    (``test_conv1d_poly_matches_jax`` runs that lowering here too)."""
    calls = {"fused": 0, "general": 0}
    spies = {"fused": (fused, "fused_resample"),
             "general": (general, "general_resample")}
    for key, (mod, fn) in spies.items():
        real = getattr(mod, fn)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    _, tp = _plans(TOPOLOGIES[name])
    gart.oneshot(tp, np.zeros((2, 2000), np.float32), device="cpu")
    assert calls == {k: int(k == wrapper) for k in calls}


@pytest.mark.parametrize("rates_q,n", [
    ((48000, 16000, 3, {}), 2000),                         # decimation
    ((48000, 16000, 3, {}), 7),
    ((44100, 48000, 3, {}), 2000),                         # rational
    ((48000, 44100, 3, {"strict_antialias": True}), 1500),  # lam head
])
def test_k1_reads_the_callers_input_in_place(monkeypatch, rates_q, n):
    """``_banded_apply`` (the rational and the strict-antialias paths) and
    the decimation branch hand K1 the caller's own tensor, its storage and
    not a padded copy: the strict prefilter's ``lam`` context goes as a
    head of zeros and the flush tail as the width.  The output equals K1's
    on the padded copy it replaces, bit for bit."""
    _, tp = _plans(rates_q)
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(2, n)))
    aux = toneshot._oneshot_aux(tp, n, torch.float64, "cpu", "highest")
    r_t, ipx, _, lam = aux
    wx, p2 = r_t.shape
    seen, real = [], fused.fused_resample

    def spy(data, r, **kw):
        seen.append((data, kw))
        return real(data, r, **kw)

    monkeypatch.setattr(fused, "fused_resample", spy)
    y = toneshot._oneshot_apply(tp, x, aux, tier="highest")
    assert len(seen) == 1
    data, kw = seen[0]
    nf = -(-tp.lengths.canonical(n) // p2)
    assert data is x and data.data_ptr() == x.data_ptr()
    assert (kw["head"], kw["width"]) == (lam or None, (nf - 1) * ipx + wx)
    assert lam == (245 if rates_q[3] else 0)
    padded = toneshot._pad_right(toneshot._pad(x, lam, 0),
                                 (nf - 1) * ipx + wx)
    want = fused.fused_resample_reference(padded, r_t, ipx=ipx, wx=wx, p2=p2,
                                          n_frames=nf, tier="highest")
    assert torch.equal(y, want[:, :tp.lengths.canonical(n)])


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_aux_holds_every_operator(monkeypatch, name):
    """``_oneshot_aux`` designs and uploads every operator, so that
    ``_oneshot_apply`` is device work only: with the host builders and
    the uploads disabled, the apply still gives the entry point's
    result."""
    _, tp = _plans(TOPOLOGIES[name])
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2000)))
    want = gart.oneshot(tp, x, device="cpu")
    aux = toneshot._oneshot_aux(tp, 2000, torch.float64, "cpu", tier="highest")
    # On the CPU the kernels' prepared operators are None.
    assert all(a is None or isinstance(a, int)
               or (isinstance(a, torch.Tensor) and a.device.type == "cpu")
               for a in aux)

    def no_host_work(*a, **kw):
        raise AssertionError("host operator work in the apply")

    for fn in ("_decim_matrix", "_fused_rational_matrix", "superframe",
               "_general_matrices", "_cubic_matrices", "_matrix_t",
               "_upload"):
        monkeypatch.setattr(toneshot, fn, no_host_work)
    assert torch.equal(toneshot._oneshot_apply(tp, x, aux,
                                               tier="highest"), want)


# -- host builders -----------------------------------------------------------------

@pytest.mark.parametrize("period", [toneshot.DECIM_PERIOD,
                                    toneshot.PALLAS_DECIM_PERIOD])
@pytest.mark.parametrize("rates_q", [(48000, 16000, 3), (96000, 48000, 3),
                                     (96000, 48000, 4), (48000, 8000, 2)])
def test_decim_matrix_bit_equal(rates_q, period):
    jp, tp = _plans(rates_q + ({},))
    jr, jp2, jipx = joneshot._decim_matrix(jp, period)
    tr, tp2, tipx = toneshot._decim_matrix(tp, period)
    assert (tp2, tipx) == (jp2, jipx) and tr.dtype == np.float64
    assert np.array_equal(tr, jr)
    assert (toneshot.DECIM_PERIOD, toneshot.PALLAS_DECIM_PERIOD,
            toneshot.DECIM_FFT_MIN_TAPS) == (
        joneshot.DECIM_PERIOD, joneshot.PALLAS_DECIM_PERIOD,
        joneshot.DECIM_FFT_MIN_TAPS)


def test_decim_geometry_48k_16k():
    """48k -> 16k HIGH: T = 1349, R [256, 2114] over Ipx 768."""
    tp = plan_engine(48000, 16000, Quality.HIGH)
    r, p, ipx = toneshot._decim_matrix(tp)
    assert (tp.decim_taps, r.shape, p, ipx) == (1349, (256, 2114), 256, 768)


@pytest.mark.parametrize("name,count", [
    ("general", 1), ("general", 700), ("general", 4460),
    ("general_hq", 1500),
])
def test_general_matrices_bit_equal(name, count):
    jp, tp = _plans(TOPOLOGIES[name])
    js, jm = joneshot._general_matrices(jp, count)
    ts, tm = toneshot._general_matrices(tp, count)
    assert ts.dtype == js.dtype and tm.dtype == np.float64
    assert np.array_equal(ts, js) and np.array_equal(tm, jm)
    for a, b in zip(toneshot._poly_walk_host(tp, count),
                    joneshot._poly_walk_host(jp, count)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rates_q,count", [
    ((44100, 48000, 0), 3266), ((48000, 44100, 0), 999),
    ((44100, 48001, 0), 1),
])
def test_cubic_matrices_bit_equal(rates_q, count):
    jp, tp = _plans(rates_q + ({},))
    js, jm = joneshot._cubic_matrices(jp, count)
    ts, tm = toneshot._cubic_matrices(tp, count)
    assert np.array_equal(ts, js) and np.array_equal(tm, jm)


def test_matrix_cache_is_bounded_in_bytes(monkeypatch):
    monkeypatch.setattr(toneshot, "_GENERAL_CACHE", OrderedDict())
    monkeypatch.setattr(toneshot, "_GENERAL_CACHE_BYTES", 0)
    tp = plan_engine(44100, 48001, Quality.HIGH)
    sizes = [sum(a.nbytes for a in toneshot._general_matrices(tp, c))
             for c in (1000, 1001, 1002, 1003)]
    assert 8 * min(sizes) > 7 * max(sizes)
    toneshot._GENERAL_CACHE.clear()
    monkeypatch.setattr(toneshot, "_GENERAL_CACHE_BYTES", 0)
    # Room for three entries, not four.
    monkeypatch.setattr(toneshot, "GENERAL_CACHE_LIMIT", 7 * max(sizes) // 2)
    first = toneshot._general_matrices(tp, 1000)
    for count in (1001, 1002):
        toneshot._general_matrices(tp, count)
    assert toneshot._general_matrices(tp, 1000) is first      # a hit
    toneshot._general_matrices(tp, 1003)                      # evicts 1001
    keys = [k[1] for k in toneshot._GENERAL_CACHE]
    assert keys == [1002, 1000, 1003]
    assert toneshot._GENERAL_CACHE_BYTES == sum(
        a.nbytes for v in toneshot._GENERAL_CACHE.values() for a in v)
    assert toneshot._GENERAL_CACHE_BYTES <= toneshot.GENERAL_CACHE_LIMIT
    assert all(k[0] == tp.fingerprint for k in toneshot._GENERAL_CACHE)


def test_band_matrix():
    kernels = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 5)))
    r, w = tconvolve.band_matrix(kernels, 4, 2, torch.float64, "cpu")
    want = np.zeros((3 * 2 + 5, 4 * 3))
    for ii in range(4):
        for ff in range(3):
            want[ii * 2:ii * 2 + 5, ii * 3 + ff] = kernels[ff].numpy()
    assert w == 11 and np.array_equal(r.numpy(), want)


# -- convolution and stages ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("f,t,stride,n", [(1, 33, 1, 900), (2, 17, 1, 400),
                                          (3, 40, 3, 1300), (1, 9, 2, 9)])
def test_conv1d_poly_matches_jax(f, t, stride, n, dtype):
    rng = np.random.default_rng(f * t)
    x = rng.normal(size=(2, n)).astype(dtype)
    k = (rng.normal(size=(f, t)) / t).astype(dtype)
    xj, kj = jnp.asarray(x), jnp.asarray(k)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    pairs = [
        (jconvolve.conv1d_poly(xj, kj, stride),
         tconvolve.conv1d_poly(xt, kt, stride)),
        (jconvolve._conv_banded(xj, kj, stride),
         tconvolve._conv_banded(xt, kt, stride, tier="highest")),
    ]
    if stride == 1:
        pairs += [
            (jconvolve.conv1d_poly_interleaved(xj, kj),
             tconvolve.conv1d_poly_interleaved(xt, kt)),
            (jconvolve._conv_banded(xj, kj, 1, interleaved=True),
             tconvolve._conv_banded(xt, kt, 1, interleaved=True,
                                    tier="highest")),
            (jstages.prestage_apply(kj, xj, f),
             tstages.prestage_apply(kt, xt, f)),
        ]
    for yj, yt in pairs:
        assert yt.dtype == xt.dtype and tuple(yt.shape) == yj.shape
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("f,t,n", [(2, 17, 400), (1, 33, 90)])
def test_conv_banded_reads_a_band_built_ahead(monkeypatch, f, t, n):
    """``band_operator`` builds the banded lowering's operator once for an
    input length; ``_conv_banded`` given it builds nothing and gives the
    same result, and refuses a band of another period."""
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(f, t)) / t).astype(np.float32))
    want = tconvolve._conv_banded(x, k, 1, interleaved=True, tier="highest")
    band = tconvolve.band_operator(k, n, 1, torch.float32, "cpu",
                                   tier="highest")
    assert band.p == min(tconvolve.BAND_PERIOD, n - t + 1) and band.op is None

    def no_build(*a, **kw):
        raise AssertionError("band built per call")

    monkeypatch.setattr(tconvolve, "band_matrix", no_build)
    got = tconvolve._conv_banded(x, k, 1, interleaved=True, band=band,
                                 tier="highest")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="period"):
        tconvolve._conv_banded(x[:, :t + 4], k, 1, interleaved=True,
                               band=band, tier="highest")


@pytest.mark.parametrize("precision,exc", [("high", None),
                                           ("default", None),
                                           ("bogus", ValueError)])
def test_conv1d_poly_precision(precision, exc):
    """The reduced tiers run: 'high' within 3e-4 of max|y| of the JAX
    lowering (exact on the CPU), 'default' within 2e-5 of max|y| of the
    JAX lowering on operands rounded to bf16 (the products agree
    exactly).  An unknown name raises."""
    if exc is not None:
        with pytest.raises(exc):
            tconvolve.conv1d_poly(torch.zeros((1, 10)), torch.zeros((1, 3)),
                                  precision=precision)
        return
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 700)).astype(np.float32)
    k = (rng.normal(size=(3, 40)) / 40).astype(np.float32)
    if precision == "default":
        xj, kj = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)) for a in (x, k))
    else:
        xj, kj = x, k
    for stride in (1, 3):
        want = np.asarray(jconvolve.conv1d_poly(jnp.asarray(xj),
                                                jnp.asarray(kj), stride))
        got = tconvolve.conv1d_poly(torch.from_numpy(x), torch.from_numpy(k),
                                    stride, precision=precision).numpy()
        assert got.shape == want.shape
        tol = 3e-4 if precision == "high" else 2e-5
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
        assert not np.array_equal(got, tconvolve.conv1d_poly(
            torch.from_numpy(x), torch.from_numpy(k), stride).numpy())


def test_gather_windows_at_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 100))
    starts = np.array([-5, 0, 13, 90, 97], dtype=np.int32)   # clipped ends
    w_j = np.asarray(jstages.gather_windows(jnp.asarray(x),
                                            jnp.asarray(starts), 12))
    w_t = tstages.gather_windows_at(torch.from_numpy(x),
                                    torch.from_numpy(starts), 12)
    assert w_t.shape == (3, 5, 12) and np.array_equal(w_t.numpy(), w_j)


# -- K3 -----------------------------------------------------------------------------

def _k3_port(x, m_t, starts, w_band, tile):
    return general.general_resample(
        torch.from_numpy(x), torch.from_numpy(m_t), torch.from_numpy(starts),
        w_band=w_band, tile=tile, tier="highest").numpy()


def test_k3_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    n_tiles, tile, w_band = 5, 256, 300
    w_pad = -(-w_band // 128) * 128
    starts = np.sort(rng.integers(0, 500, size=n_tiles)).astype(np.int32)
    m = rng.normal(size=(n_tiles, tile, w_band)) / np.sqrt(w_band)
    fetch = (-(-(w_pad + 128) // 128) * 128) + 128
    x = rng.normal(size=(pf.STREAM_TILE, int(starts[-1]) + fetch)).astype(
        np.float32)
    m_t = np.zeros((n_tiles, w_pad, tile), dtype=np.float32)
    m_t[:, :w_band, :] = np.transpose(m, (0, 2, 1))
    y_j = np.asarray(pf.general_resample_pallas(
        jnp.asarray(x), jnp.asarray(m_t), jnp.asarray(starts),
        w_band=w_band, tile=tile, interpret=True))
    y_t = _k3_port(x, m_t, starts, w_band, tile)
    assert y_t.shape == y_j.shape == (pf.STREAM_TILE, n_tiles * tile)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=TOL[np.float32])


def test_k3_plain_matches_pallas_interpret_general_matrices():
    plan = plan_engine(44100, 48001, Quality.HIGH)
    count = plan.lengths.canonical(4096)
    starts, m = toneshot._general_matrices(plan, count)
    w_band, tile = m.shape[2], m.shape[1]
    w_pad = -(-w_band // 128) * 128
    fetch = (-(-(w_pad + 128) // 128) * 128) + 128
    x = np.random.default_rng(3).normal(size=(8, int(starts[-1]) + fetch))
    x = x.astype(np.float32)
    m_t = np.zeros((m.shape[0], w_pad, tile), dtype=np.float32)
    m_t[:, :w_band, :] = np.transpose(m, (0, 2, 1))
    y_j = np.asarray(pf.general_resample_pallas(
        jnp.asarray(x), jnp.asarray(m_t), jnp.asarray(starts, jnp.int32),
        w_band=w_band, tile=tile, ts=8, interpret=True))
    y_t = _k3_port(x, m_t, starts, w_band, tile)
    np.testing.assert_allclose(y_t[:, :count], y_j[:, :count], rtol=0,
                               atol=TOL[np.float32])


def test_k3_plain_version_clamps_outside_the_input():
    """Window samples before 0 or past the end read the nearest end, as
    the JAX package's clipped gather reads them."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 50))
    m_t = rng.normal(size=(3, 20, 7))
    starts = np.array([-4, 10, 40])
    y = _k3_port(x, m_t, starts, 20, 7)
    xp = np.concatenate([np.repeat(x[:, :1], 4, 1), x,
                         np.repeat(x[:, -1:], 20, 1)], axis=1)
    want = np.concatenate([xp[:, s + 4:s + 24] @ m_t[t]
                           for t, s in enumerate(starts)], axis=1)
    np.testing.assert_allclose(y, want, rtol=0, atol=TOL[np.float64])


def test_k3_wrapper_on_cpu():
    x = torch.zeros((2, 50))
    m_t = torch.zeros((3, 20, 7))
    starts = torch.tensor([0, 5, 9])
    before = general.launches
    assert general.general_resample(x, m_t, starts, w_band=16,
                                    tile=7, tier="highest").shape == (2, 21)
    assert general.launches == before
    with pytest.raises(ValueError, match="tile=8"):
        general.general_resample(x, m_t, starts, w_band=16, tile=8,
                                 tier="highest")
    with pytest.raises(ValueError, match="2 starts"):
        general.general_resample(x, m_t, starts[:2], w_band=16, tile=7,
                                 tier="highest")
    with pytest.raises(TypeError, match="int32 or int64"):
        general.general_resample(x, m_t, starts.float(), w_band=16, tile=7,
                                 tier="highest")
