"""Quality metrics measured on the port's output on the card.

Counterpart of the JAX package's ``tools/quality_tpu.py``: the CPU suite
proves the math; this tool measures the shipped compute path, float32 on
the card with the CUDA kernels on.  It runs the THD, DC-gain, anti-alias
and ripple metrics on the one-shot's output, the non-exact streaming
engine against its one-shot, the matmul tiers, ``hq_interp``, each
kernel against its plain version (``ops.precision.force_xla``) and a soak
with a checkpoint under load, holds each to the floors of
``QUALITY_tpu.json``, and writes ``QUALITY_cuda.json`` with the card's
name and power limit.

Usage:
    python -m go_audio_resampler_tpu_torch.tools.quality_cuda \
        [--out QUALITY_cuda.json] [--allow-cpu]

Without a card it refuses to run unless given ``--allow-cpu`` (a smoke
run on the kernels' plain versions; the record means something only on
the card).  Exit code 1 if any floor or parity check fails.  Each section
is a function of a :class:`Record` and a device, so a caller (or a test)
may run any of them alone.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from ..engine import EngineCore, load_stream_state, oneshot, \
    plan_engine, save_stream_state
from ..filterdesign import Quality
from ..ops.precision import force_xla
from ..utils import metrics, signals
from ..utils.roofline import power_limit

N = 65536
FFT = 16384
TIER_ENV = "GAR_TPU_MATMUL_PRECISION"

#: Each check's limit, as ``QUALITY_tpu.json`` states it: the ceiling of a
#: THD (dB), the floor of a rejection (dB), the bound of |dc - 1|, of the
#: ripple (dB peak to peak) or of a difference; 0 for the checks of bit
#: equality; None where the check is a bound on state, or a record.
LIMITS = {
    "thd_44k_48k_low_db": -130.0,
    "thd_44k_48k_high_db": -140.0,
    "thd_44k_48k_very_high_db": -140.0,
    "thd_96k_48k_high_db": -130.0,
    "alias_rejection_96k_48k_db": 100.0,
    "dc_gain_44k_48k_high": 1e-3,
    "passband_ripple_44k_48k_db": 2.0,
    "thd_stream_44k_48k001_high_db": -85.0,
    "stream_vs_oneshot_general_maxdiff": 2e-5,
    "kernel_parity_rational_cd_dat_maxdiff": 2e-5,
    "kernel_parity_decimation_2x_maxdiff": 2e-5,
    "kernel_parity_general_44k_48k001_maxdiff": 2e-5,
    "thd_44k_48k_high_fast_tier_db": -110.0,
    "thd_44k_48k_high_ingest_tier_db": -65.0,
    "thd_stream_44k_48k001_hq_interp_db": -120.0,
    "soak_random_chunks_equal_bulk_maxdiff": 0.0,
    "soak_checkpoint_resume_maxdiff": 0.0,
    "soak_host_state_bounded": None,
    "soak_wall_s": None,
}


class Record:
    """The checks measured so far: ``checks[name] = {"value", "pass",
    "note"}``, each printed as it is recorded; ``failures`` names those
    that failed."""

    def __init__(self):
        self.checks: dict = {}
        self.failures: list[str] = []

    def __call__(self, name, value, ok, note=""):
        self.checks[name] = {"value": value, "pass": bool(ok),
                             **({"note": note} if note else {})}
        print(f"  [{'ok  ' if ok else 'FAIL'}] {name} = {value}")
        if not ok:
            self.failures.append(name)


def run(plan, x, device) -> np.ndarray:
    """The one-shot of one stream ``x`` in float32 on ``device``, as
    float64 numpy."""
    y = oneshot(plan, np.asarray(x, np.float32)[None], dtype=torch.float32,
                device=device)
    return y[0].cpu().numpy().astype(np.float64)


def _stream(plan, x: np.ndarray, device, block: int = 4096) -> np.ndarray:
    """One stream through ``EngineCore.process`` in ``block`` chunks, then
    flushed, as float64 numpy."""
    eng = EngineCore(plan, batch=1, block=block, dtype=torch.float32,
                     device=device)
    chunks = [eng.process(x[None, i:i + block])
              for i in range(0, len(x), block)]
    chunks.append(eng.flush())
    return np.concatenate([c[0] for c in chunks]).astype(np.float64)


def _rms_amplitude(y: np.ndarray) -> float:
    mid = y[len(y) // 4: -len(y) // 4]
    return float(np.sqrt(np.mean(mid ** 2)) * np.sqrt(2.0))


def thd_floors(rec: Record, device) -> None:
    """THD of 44.1k -> 48k at LOW, HIGH and VERY_HIGH."""
    print("THD floors on device output:")
    for q in (Quality.LOW, Quality.HIGH, Quality.VERY_HIGH):
        name = f"thd_44k_48k_{q.name.lower()}_db"
        plan = plan_engine(44100.0, 48000.0, q)
        y = run(plan, signals.sine(N, 1000.0, 44100), device)
        val = metrics.thd(y, 48000, 1000.0, FFT)
        rec(name, round(val, 2), val <= LIMITS[name],
            f"floor {LIMITS[name]}")


def decimation(rec: Record, device) -> None:
    """THD of 96k -> 48k HIGH and the rejection of a 30 kHz tone (which
    would alias to 18 kHz at 48k out)."""
    plan = plan_engine(96000.0, 48000.0, Quality.HIGH)
    y = run(plan, signals.sine(N, 1000.0, 96000), device)
    val = metrics.thd(y, 48000, 1000.0, FFT)
    rec("thd_96k_48k_high_db", round(val, 2),
        val <= LIMITS["thd_96k_48k_high_db"], "floor -130")
    y = run(plan, signals.sine(N, 30000.0, 96000), device)
    att = -20.0 * np.log10(max(_rms_amplitude(y), 1e-12))
    rec("alias_rejection_96k_48k_db", round(att, 1),
        att >= LIMITS["alias_rejection_96k_48k_db"],
        "floor 100 (the float32 noise floor bounds this, not the filter)")


def dc_gain(rec: Record, device) -> None:
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    dc = metrics.dc_gain(run(plan, signals.dc(16384), device))
    rec("dc_gain_44k_48k_high", round(float(dc), 6),
        abs(dc - 1.0) <= LIMITS["dc_gain_44k_48k_high"], "|dc-1| <= 1e-3")


def ripple(rec: Record, device) -> None:
    """Passband ripple of 44.1k -> 48k HIGH over four tones."""
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    amps = [_rms_amplitude(run(plan, signals.sine(N, f, 44100), device))
            for f in (1000.0, 5000.0, 10000.0, 15000.0)]
    val = 20.0 * np.log10(max(amps) / min(amps))
    rec("passband_ripple_44k_48k_db", round(float(val), 4),
        val <= LIMITS["passband_ripple_44k_48k_db"], "floor 2.0 dB p-p")


def stream_general(rec: Record, device) -> None:
    """The streaming engine at a non-exact ratio (the walk: the K1
    prestage and the polyphase emit) in 4096-sample chunks: its THD, and
    its stream against the one-shot of the same plan (K3)."""
    print("Streaming engine (non-exact ratio) on device output:")
    plan = plan_engine(44100.0, 48001.0, Quality.HIGH)
    xs = signals.sine(N, 1000.0, 44100).astype(np.float32)
    y_s = _stream(plan, xs, device)
    val = metrics.thd(y_s, 48001, 1000.0, FFT)
    rec("thd_stream_44k_48k001_high_db", round(val, 2),
        val <= LIMITS["thd_stream_44k_48k001_high_db"],
        "floor -85: the cubic inter-phase coefficient interpolation bounds "
        "non-exact ratios (about -88.7 in float64 too, the reference's walk "
        "semantics; exact-rational paths measure about -155)")
    y_o = run(plan, xs, device)
    m = min(len(y_s), len(y_o))
    d = float(np.abs(y_s[:m] - y_o[:m]).max())
    rec("stream_vs_oneshot_general_maxdiff", d,
        len(y_s) == len(y_o)
        and d <= LIMITS["stream_vs_oneshot_general_maxdiff"],
        "tol 2e-5, equal lengths")


def kernel_parity(rec: Record, device, n: int = 44100) -> None:
    """Each kernel against its plain version: the one-shot of 64 streams
    of ``n`` samples with the kernels (K1: rational, decimation; K3:
    general), then under ``force_xla``.  Off the card both sides are the
    plain version, so the section is skipped there."""
    print("Kernel against plain version (the card's numerics):")
    if torch.device(device).type != 'cuda':
        print("  (skipped off the card: both sides are the plain version)")
        return
    rng = np.random.default_rng(0)
    for name, inr, outr in (("rational_cd_dat", 44100, 48000),
                            ("decimation_2x", 96000, 48000),
                            ("general_44k_48k001", 44100, 48001)):
        plan = plan_engine(float(inr), float(outr), Quality.HIGH)
        x = (rng.normal(size=(64, n)) * 0.5).astype(np.float32)
        y_k = oneshot(plan, x, dtype=torch.float32, device=device)
        with force_xla():
            y_p = oneshot(plan, x, dtype=torch.float32, device=device)
        d = float((y_k - y_p).abs().max())
        name = f"kernel_parity_{name}_maxdiff"
        rec(name, d, d <= LIMITS[name], "tol 2e-05")


class _tier:
    """Context manager: the process-wide matmul tier set to ``tier`` (read
    by ``oneshot`` once per call), then restored."""

    def __init__(self, tier: str):
        self.tier = tier

    def __enter__(self):
        self.prev = os.environ.get(TIER_ENV)
        os.environ[TIER_ENV] = self.tier

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop(TIER_ENV, None)
        else:
            os.environ[TIER_ENV] = self.prev


def tiers(rec: Record, device) -> None:
    """THD of 44.1k -> 48k HIGH at the opt-in bf16 tiers: 'high' (three
    bf16 passes) and 'default' (one, the ingest tier)."""
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    for tier, name, label in (
            ("high", "thd_44k_48k_high_fast_tier_db",
             "Fast matmul tier (bf16x3)"),
            ("default", "thd_44k_48k_high_ingest_tier_db",
             "Ingest matmul tier (1-pass bf16)")):
        print(f"{label} on device output:")
        with _tier(tier):
            y = run(plan, signals.sine(N, 1000.0, 44100), device)
        val = metrics.thd(y, 48000, 1000.0, FFT)
        rec(name, round(val, 2), val <= LIMITS[name],
            f"floor {LIMITS[name]:g} (opt-in tier, not a preset)")


def hq_interp(rec: Record, device) -> None:
    """The general walk with the corrected inter-phase interpolation."""
    print("HQ inter-phase mode (hq_interp=True) on device output:")
    plan = plan_engine(44100.0, 48001.0, Quality.HIGH, False, True)
    xs = signals.sine(N, 1000.0, 44100).astype(np.float32)
    val = metrics.thd(_stream(plan, xs, device), 48001, 1000.0, FFT)
    rec("thd_stream_44k_48k001_hq_interp_db", round(val, 2),
        val <= LIMITS["thd_stream_44k_48k001_hq_interp_db"],
        "floor -120 (float64 measures about -162; the default walk about "
        "-88)")


def _fifo_state(eng: EngineCore) -> tuple[int, int]:
    """(samples buffered, buffer width) of the engine's input FIFO."""
    return eng._pending.available(), eng._pending._buf.shape[-1]


def soak(rec: Record, device, seconds: float = 15.0) -> None:
    """``seconds`` of 8 streams of 44.1k -> 48k HIGH through ``process()``
    in random chunks, against one bulk call (bit for bit); a checkpoint
    at a random chunk seam, resumed bit for bit; and the input FIFO's
    fill and width, sampled after every chunk while feeding (after the
    flush it is empty whatever it held), bounded."""
    print("Soak tier (randomized chunks, checkpoint under load):")
    t_soak = time.monotonic()
    n_soak = int(seconds * 44100)
    rng = np.random.default_rng(7)
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    x = (rng.standard_normal((8, n_soak)) * 0.5).astype(np.float32)

    def engine():
        return EngineCore(plan, batch=8, block=8192, dtype=torch.float32,
                          device=device)

    bulk = engine()
    y_bulk = np.concatenate([bulk.process(x), bulk.flush()], axis=1)

    # Random chunk seams with the checkpoint position forced onto one.
    cut = int(rng.integers(n_soak // 4, 3 * n_soak // 4))
    cuts = [0]
    while cuts[-1] < n_soak:
        cuts.append(min(n_soak, cuts[-1] + int(rng.integers(1, 70000))))
    cuts = sorted(set(cuts + [cut]))

    a = engine()
    parts, pend, width = [], 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "soak.npz")
        for lo, hi in zip(cuts, cuts[1:]):
            parts.append(a.process(x[:, lo:hi]))
            p, w = _fifo_state(a)
            pend, width = max(pend, p), max(width, w)
            if hi == cut:
                save_stream_state(a, ck)
        y_a = np.concatenate(parts + [a.flush()], axis=1)
        b = engine()
        load_stream_state(b, ck)
    # Replay only the tail through the restored engine; its outputs must
    # splice bit for bit onto the interrupted stream's.  parts[i] covers
    # (cuts[i], cuts[i+1]); the checkpoint was saved after the chunk
    # ending at cut.
    n_pre = cuts.index(cut)
    pre = np.concatenate(parts[:n_pre], axis=1)
    tail_cuts = [c for c in cuts if c >= cut]
    tail = [b.process(x[:, lo:hi])
            for lo, hi in zip(tail_cuts, tail_cuts[1:])]
    y_resumed = np.concatenate([pre] + tail + [b.flush()], axis=1)

    d_bulk = (float(np.abs(y_a - y_bulk).max())
              if y_a.shape == y_bulk.shape else float("inf"))
    rec("soak_random_chunks_equal_bulk_maxdiff", d_bulk,
        d_bulk <= LIMITS["soak_random_chunks_equal_bulk_maxdiff"],
        f"{len(cuts) - 1} random chunks against one bulk call over "
        f"{seconds:g} s x 8 streams, bit for bit")
    d_ck = (float(np.abs(y_resumed - y_bulk).max())
            if y_resumed.shape == y_bulk.shape else float("inf"))
    rec("soak_checkpoint_resume_maxdiff", d_ck,
        d_ck <= LIMITS["soak_checkpoint_resume_maxdiff"],
        f"checkpoint at sample {cut} under load, the restored engine "
        "splices bit for bit")
    rec("soak_host_state_bounded", int(width),
        pend < 2 * a.block and width <= 8 * max(a.block, 70000),
        f"input FIFO sampled after each of {len(cuts) - 1} chunks: at most "
        f"{pend} samples held, width {width}")
    rec("soak_wall_s", round(time.monotonic() - t_soak, 1), True)


#: Every section, in the order of the JAX tool.
SECTIONS = (thd_floors, decimation, dc_gain, ripple, stream_general,
            kernel_parity, tiers, hq_interp, soak)


def card() -> tuple[str, str | None]:
    """The current card's name and power limit (``nvidia-smi``'s)."""
    index = torch.cuda.current_device()
    return torch.cuda.get_device_name(index), power_limit(index)


def run_checks(device='cuda', sections=SECTIONS) -> dict:
    """Run ``sections`` on ``device``; the record as written to the
    output file."""
    device = torch.device(device)
    results: dict = {"backend": device.type, "dtype": "float32"}
    if device.type == 'cuda':
        results["device"], results["power_limit"] = card()
    rec = Record()
    for section in sections:
        section(rec, device)
    results["checks"] = rec.checks
    results["failures"] = rec.failures
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="QUALITY_cuda.json")
    ap.add_argument("--allow-cpu", action="store_true",
                    help="run on the CPU where there is no card (a smoke "
                         "run; the record means something only on the "
                         "card)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() and not args.allow_cpu:
        print("refusing to run without CUDA (pass --allow-cpu for a smoke "
              "run on the CPU)")
        return 1
    results = run_checks('cuda' if torch.cuda.is_available() else 'cpu')
    out = pathlib.Path(args.out)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out}: {len(results['failures'])} failure(s)")
    return 1 if results["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
