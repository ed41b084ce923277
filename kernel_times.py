#!/usr/bin/env python3
"""Time the port's kernels, for one tree of the repository: K1 and K2 at
the main path's and the decimation path's shapes, K3 at the one-shot
general and cubic shapes.

    python3 kernel_times.py [--root DIR] [--tag NAME] [--seed N]
                            [--path-runs N] [--tier TIER]

Imports ``go_audio_resampler_tpu_torch`` from DIR (by default the
directory of this file), builds its kernels there and prints one JSON
line: the card, the tag, and for each kernel and shape its ms per launch
and its largest difference from its plain version.  Running it on two
trees in one call on the card, in turns (A, B, B, A), compares two
versions on one card: e.g. a parent commit unpacked with ``git archive``
into a directory that ``.gitignore`` lists, and the working tree.

Shapes: 44.1 kHz -> 48 kHz HIGH, 1024 streams, one 2352-sample step
([1024, 2646] data, R_t [343, 160], 16 frames); 48 kHz -> 16 kHz HIGH,
256 streams, one 3072-sample step ([256, 4422] data, R_t [2882, 512], 2
frames).  K2 takes the same data transposed.  For a tree whose K1 reads
its rows in pieces (``head``, ``width``), K1 is also timed on the same
rows as the engine's carry beside its block (``k1_<shape>_head_ms``: the
carry laid out as the streaming step leaves it, where the tree lays it
out; ``k1_<shape>_head_packed_ms``: a contiguous carry, as the first
step reads its zeros) and cut short of a zero tail of about half a frame
(``k1_<shape>_tail_ms``), each checked bit for bit against the whole
row, and ``cat_<shape>_ms`` times the ``torch.cat`` of carry and block
that a step made before K1 read them in place.  K1 alone also at a 2x
prestage's shape ([256, 2213] data, R_t [293, 256], 16 frames, no head).
K3: 64 streams of 2 s,
44.1 kHz -> 48.001 kHz HIGH (x [64, 88783], M [376, 420, 256]) and
44.1 kHz -> 48 kHz QUICK (M [376, 239, 256]), as ``chip_smoke.k3_operands``
builds them; M's band table and block width go to a tree whose wrapper
takes ``bands`` and ``warpgroups`` (the other block width is timed too),
and ``torch.bmm`` over the gathered frames (the gather not
timed) is timed beside it.  Each time is a CUDA graph of 20 launches
replayed 10 times (``chip_smoke.graph_ms``; 5 of 5 for ``bmm``), so the
host's enqueue time is not counted.  Inputs come from ``--seed``; TF32
is off for the plain versions.

``--tier`` ('highest' by default, 'high' or 'default'; see
``ops/precision.py``) runs every kernel and plain version at that matmul
tier, for a tree whose wrappers take ``tier``; at 'high' and 'default'
``torch.matmul`` (K1, K2) and ``torch.bmm`` (K3) on bf16 operands are
timed beside them (the casts not timed).

``--save FILE`` writes each kernel's output at each shape (on the
seed's inputs) to FILE with ``torch.save``, so that two trees' bits can be
compared.

``--path-runs N`` also drives ``chip_smoke.py``'s decimation path (48 kHz
-> 16 kHz HIGH, 256 streams x 10.016 s, 3072-sample steps) N times
through each engine, each time once after ``torch.cuda.empty_cache()``
("cold": PyTorch's allocator adds segments for the 1 MiB step outputs)
and once more from the reset engine ("warm": the blocks are cached), and
records each run as ``chip_smoke.timed_run`` does.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

from chip_smoke import (DECIM_IN, DECIM_OUT, DECIM_SAMPLES, DECIM_STREAMS,
                        K3_SHAPES, ONESHOT_STREAMS, graph_ms, k3_operands,
                        timed_run)


def path_runs(runs: int, gen) -> dict:
    """Per engine and kind (cold, warm), each run's input Msamples/s, its
    largest step host time (ms), its steps over 0.5 ms, its device span
    (ms) and the allocator segments it added (see the module docstring).
    """
    import torch
    from go_audio_resampler_tpu_torch import (EngineCore, Quality,
                                              TimeMajorEngine, plan_engine)
    plan = plan_engine(DECIM_IN, DECIM_OUT, Quality.HIGH)
    n = DECIM_SAMPLES
    x = 0.5 * torch.randn((DECIM_STREAMS, n), generator=gen, device="cuda")
    xt = x.t().contiguous()
    engines = (
        ("EngineCore", EngineCore(plan, batch=DECIM_STREAMS, block=2048),
         lambda a, b: x[:, a:b]),
        ("TimeMajorEngine", TimeMajorEngine(plan, batch=DECIM_STREAMS,
                                            block=2048),
         lambda a, b: xt[a:b]))
    block = engines[0][1].block
    chunks = [(a, min(n, a + block)) for a in range(0, n, block)]
    rec = {}
    for _ in range(runs):
        for name, eng, data in engines:
            for kind in ("cold", "warm"):
                if kind == "cold":
                    torch.cuda.empty_cache()
                eng.reset()
                torch.cuda.synchronize()
                outs, st = timed_run(eng, data, chunks)
                del outs
                steps = st["steps_ms"]
                r = rec.setdefault(f"{name}_{kind}", {
                    "rate": [], "max_step_ms": [], "slow_steps": [],
                    "device_ms": [], "segments": []})
                r["rate"].append(DECIM_STREAMS * n / st["wall"] / 1e6)
                r["max_step_ms"].append(float(steps.max()))
                r["slow_steps"].append(int((steps > 0.5).sum()))
                r["device_ms"].append(st["device_ms"])
                r["segments"].append(st["segments"])
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="repository tree whose port is timed")
    ap.add_argument("--tag", default="", help="name printed with the times")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path-runs", type=int, default=0,
                    help="also drive the decimation path this many times "
                         "through each engine, cold and warm")
    ap.add_argument("--save", default="",
                    help="write the kernels' outputs to this file")
    ap.add_argument("--tier", default="highest",
                    choices=("highest", "high", "default"),
                    help="matmul tier of the kernels and plain versions")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from go_audio_resampler_tpu_torch import EngineCore, Quality, plan_engine
    from go_audio_resampler_tpu_torch.engine import streaming
    from go_audio_resampler_tpu_torch.ops import _build, fused, general, tmajor
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(["fused_resample", "fused_resample_tmajor",
                      "general_resample"])
    takes_op = "op" in inspect.signature(fused.fused_resample).parameters
    k3_params = inspect.signature(general.general_resample).parameters
    tiered = "tier" in inspect.signature(fused.fused_resample).parameters
    in_place = "head" in inspect.signature(fused.fused_resample).parameters
    if args.tier != "highest" and not tiered:
        print(f"kernel_times: {args.root} has no tier {args.tier!r}",
              file=sys.stderr)
        return 2
    tier = {"tier": args.tier} if tiered else {}
    bf16 = args.tier != "highest"

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    out = {"tag": args.tag, "card": card, "root": os.path.abspath(args.root),
           "tier": args.tier}
    saved = {}
    for shape, rates, block, streams, n_frames, width in (
            ("main", (44100, 48000), 2352, 1024, 16, 2646),
            ("decimation", (48000, 16000), 2048, 256, 2, 4422)):
        eng = EngineCore(plan_engine(*rates, Quality.HIGH), block=block,
                         device="cpu")
        r_t, ipx, wx, p2 = eng._band[:4]
        rt = r_t.to("cuda")
        r = rt.t().contiguous()
        kw = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, **tier)
        if takes_op:
            from go_audio_resampler_tpu_torch.ops import banded
            kw["op"] = banded.prepare(rt, **tier)
        x = torch.randn((streams, width), generator=gen, device="cuda")
        xt = x.t().contiguous()
        plain = dict(ipx=ipx, wx=wx, p2=p2, n_frames=n_frames, **tier)
        ref = fused.fused_resample_reference(x, rt, **plain)
        y1 = fused.fused_resample(x, rt, **kw)
        y2 = tmajor.fused_resample_tmajor(xt, r, **kw)
        torch.cuda.synchronize()
        saved[f"k1_{shape}"], saved[f"k2_{shape}"] = y1.cpu(), y2.cpu()
        out[f"k1_{shape}_err"] = (y1 - ref).abs().max().item()
        out[f"k2_{shape}_err"] = (y2.t() - ref).abs().max().item()
        out[f"k1_{shape}_ms"] = graph_ms(
            lambda: fused.fused_resample(x, rt, **kw))
        if in_place:
            # The same rows read in pieces: the streaming carry as a head
            # beside the block, and the data cut short of a zero tail (a
            # one-shot's flush), each against the whole row's bits.
            c = eng._band.carry
            head, body = x[:, :c].contiguous(), x[:, c:].contiguous()
            out[f"cat_{shape}_ms"] = graph_ms(
                lambda: torch.cat([head, body], dim=1))
            out[f"k1_{shape}_head_packed_equal"] = torch.equal(
                fused.fused_resample(body, rt, head=head, **kw), y1)
            out[f"k1_{shape}_head_packed_ms"] = graph_ms(
                lambda: fused.fused_resample(body, rt, head=head, **kw))
            if hasattr(streaming, "_next_carry"):
                # laid out as the streaming step leaves its carry
                laid = streaming._next_carry(head, body)
                head = laid.copy_(head)
            need = (n_frames - 1) * ipx + wx
            cut = x[:, :need - ipx // 2 - 1].contiguous()
            zeroed = torch.cat([cut, torch.zeros_like(x[:, cut.shape[1]:])],
                               dim=1)
            y_tail = fused.fused_resample(zeroed, rt, **kw)
            out[f"k1_{shape}_head_equal"] = torch.equal(
                fused.fused_resample(body, rt, head=head, **kw), y1)
            out[f"k1_{shape}_tail_equal"] = torch.equal(
                fused.fused_resample(cut, rt, width=width, **kw), y_tail)
            out[f"k1_{shape}_head_ms"] = graph_ms(
                lambda: fused.fused_resample(body, rt, head=head, **kw))
            out[f"k1_{shape}_tail_ms"] = graph_ms(
                lambda: fused.fused_resample(cut, rt, width=width, **kw))
            del head, body, cut, zeroed
        out[f"k2_{shape}_ms"] = graph_ms(
            lambda: tmajor.fused_resample_tmajor(xt, r, **kw))
        if bf16:
            need = (n_frames - 1) * ipx + wx
            xb = x.to(torch.bfloat16)
            frames = xb[:, :need].unfold(1, wx, ipx)
            frames_t = xb.t()[:need].unfold(0, wx, ipx).transpose(1, 2)
            rb, rbt = rt.to(torch.bfloat16), r.to(torch.bfloat16)
            out[f"k1_{shape}_plain_ms"] = graph_ms(
                lambda: fused.fused_resample_reference(x, rt, **plain),
                reps=5, iters=5)
            out[f"matmul_bf16_k1_{shape}_ms"] = graph_ms(
                lambda: torch.matmul(frames, rb), reps=5, iters=5)
            out[f"matmul_bf16_k2_{shape}_ms"] = graph_ms(
                lambda: torch.matmul(rbt, frames_t), reps=5, iters=5)
            del xb, frames, frames_t
    # K1 alone, with no head and data as wide as its frames, at the 2x
    # prestage's shape (convolve._conv_banded: 256 streams, 2 phases of
    # 166 taps at stride 1 in periods of 128, R_t [293, 256], 16 frames).
    from go_audio_resampler_tpu_torch.ops import convolve
    rt, _ = convolve.band_matrix(
        torch.randn((2, 166), generator=gen, device="cuda"), 128, 1,
        torch.float32, "cuda")
    kw = dict(ipx=128, wx=293, p2=256, n_frames=16, **tier)
    if takes_op:
        from go_audio_resampler_tpu_torch.ops import banded
        kw["op"] = banded.prepare(rt, **tier)
    x = torch.randn((256, 2213), generator=gen, device="cuda")
    y1 = fused.fused_resample(x, rt, **kw)
    ref = fused.fused_resample_reference(
        x, rt, ipx=128, wx=293, p2=256, n_frames=16, **tier)
    saved["k1_prestage"] = y1.cpu()
    out["k1_prestage_err"] = (y1 - ref).abs().max().item()
    out["k1_prestage_ms"] = graph_ms(
        lambda: fused.fused_resample(x, rt, **kw))
    for shape in K3_SHAPES:
        starts, m, bands, wgs = k3_operands(shape)
        _, w_band, tile = m.shape
        x = 0.5 * torch.randn((ONESHOT_STREAMS, int(starts[-1]) + w_band),
                              generator=gen, device="cuda")
        kw = dict(w_band=w_band, tile=tile, **tier)
        if "bands" in k3_params:
            kw["bands"] = bands
        if "warpgroups" in k3_params:
            kw["warpgroups"] = wgs
            out[f"k3_{shape}_warpgroups"] = wgs
        ref = general.general_resample_reference(x, m, starts, w_band=w_band,
                                                 tile=tile, **tier)
        y = general.general_resample(x, m, starts, **kw)
        idx = starts[:, None] + torch.arange(w_band, device="cuda")[None, :]
        frames = x[:, idx].permute(1, 0, 2).contiguous()     # [T, S, W]
        torch.cuda.synchronize()
        saved[f"k3_{shape}"] = y.cpu()
        out[f"k3_{shape}_err"] = (y - ref).abs().max().item()
        out[f"k3_{shape}_ms"] = graph_ms(
            lambda: general.general_resample(x, m, starts, **kw))
        if "warpgroups" in kw:              # the block width not chosen
            other = dict(kw, warpgroups=3 - wgs)
            out[f"k3_{shape}_other_width_ms"] = graph_ms(
                lambda: general.general_resample(x, m, starts, **other))
        out[f"bmm_{shape}_ms"] = graph_ms(lambda: torch.bmm(frames, m),
                                          reps=5, iters=5)
        if bf16:
            fb, mb = frames.to(torch.bfloat16), m.to(torch.bfloat16)
            out[f"bmm_bf16_{shape}_ms"] = graph_ms(lambda: torch.bmm(fb, mb),
                                                   reps=5, iters=5)
            del fb, mb
        del frames
    if args.save:
        torch.save(saved, args.save)
    if args.path_runs:
        out["decimation_runs"] = path_runs(args.path_runs, gen)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
