"""Mutation check of the port: the suite catches injected bugs.

Counterpart of the JAX repo's ``tools/mutation_check.py``, held to the
port.  Each mutation edits one file of ``go_audio_resampler_tpu_torch/``
(through a ``.mutbak`` copy that is always put back), runs the port's
tests that should catch it, and reports CAUGHT (the tests failed) or
SURVIVED (they passed).  A surviving mutant means the suite cannot tell
that path's wrong result from the right one; the run exits 1.

The CPU set (``MUTATIONS``) mutates the host walks, the length model,
the one-shot, the fusion algebra and the kernels' plain versions; its
targets are ``tests/test_torch_*.py`` files run here.  The card set
(``--cuda``, ``CUDA_MUTATIONS``) mutates the CUDA kernels themselves;
its target is ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` on a machine with a GPU and ``nvcc``.  Each
CUDA mutant is one ``nvcc`` build: ``ops/_build.py`` names a library by a
digest of its sources, so a mutant is built anew and never loaded stale.

Before the mutants, the unmutated tree runs the selected targets once:
a test that fails there would count every mutant as caught, so the run
stops with exit code 2.

Usage (from the repo root):
    python -m go_audio_resampler_tpu_torch.tools.mutation_check \
        [--cuda] [filter]
(the optional filter substring selects mutations by file path or note).
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import signal
import subprocess
import sys
from typing import NamedTuple

REPO = pathlib.Path(__file__).resolve().parents[2]
PACKAGE = REPO / "go_audio_resampler_tpu_torch"
BACKUP = ".mutbak"
#: Bound on one pytest run (the card's target builds its kernels first).
TIMEOUT_S = 1800
CUDA_TARGETS = ("tests/test_torch_cuda.py",)
#: pytest's options for the card set: the cases marked ``cuda``, without
#: ``tests/conftest.py`` (it imports JAX, which a GPU machine may lack).
CUDA_OPTIONS = ("--noconftest", "-m", "cuda")


class Mutation(NamedTuple):
    path: str                  # relative to the repo root
    old: str                   # occurs exactly once in the file
    new: str
    targets: tuple[str, ...]   # test files, or test ids within them
    note: str


MUTATIONS = [
    # --- the counterparts of the JAX check's twelve ---
    Mutation(
        "go_audio_resampler_tpu_torch/engine/counts.py",
        "num_out = (limit - self.at + self.step - 1) // self.step",
        "num_out = (limit - self.at) // self.step",
        ("tests/test_torch_plan.py",),
        "poly count model: floor instead of ceil"),
    # As in the JAX check, an over-consume mutant (consumed += 1 in
    # PolyphaseSim.process) is equivalent under canonical()'s three large
    # blocks; the window count is mutated instead.
    Mutation(
        "go_audio_resampler_tpu_torch/engine/counts.py",
        "num_in = self.hist - self.taps + 1",
        "num_in = self.hist - self.taps + 2",
        ("tests/test_torch_plan.py",),
        "poly count model: valid-window count off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/engine/stages.py",
        "x = frac.to(hist.dtype) * (1.0 / 65536.0)",
        "x = frac.to(hist.dtype) * (1.0 / 65600.0)",
        ("tests/test_torch_stages.py",),
        "streaming walk: wrong fraction scale of the emit's phases"),
    Mutation(
        "go_audio_resampler_tpu_torch/engine/oneshot.py",
        "at = plan.at0 + np.arange(count, dtype=np.int64) * plan.step",
        "at = plan.at0 + 1 + np.arange(count, dtype=np.int64) * plan.step",
        ("tests/test_torch_oneshot.py",),
        "oneshot host walk: phase origin off by one frac unit"),
    Mutation(
        "go_audio_resampler_tpu_torch/ops/fused.py",
        "    frames = gather_windows(data, n_frames, ipx, wx)      # [S, F, Wx]",
        "    frames = gather_windows(data.roll(-1, 1), n_frames, ipx, wx)",
        ("tests/test_torch_fused.py",),
        "K1's plain version: frame window start off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/ops/general.py",
        "    frames = gather_windows_at(x, starts, w_band)        # [S, n_tiles, W]",
        "    frames = gather_windows_at(x, starts + 1, w_band)",
        ("tests/test_torch_general.py",),
        "K3's plain version: window start off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/engine/oneshot.py",
        "    rs = np.zeros((kf * p, ws), dtype=r.dtype)\n"
        "    for f in range(kf):\n"
        "        rs[f * p:(f + 1) * p, f * ipx:f * ipx + w] = r",
        "    rs = np.zeros((kf * p, ws), dtype=r.dtype)\n"
        "    for f in range(kf):\n"
        "        rs[f * p:(f + 1) * p, f * (ipx - 1):f * (ipx - 1) + w] = r",
        ("tests/test_torch_plan.py", "tests/test_torch_oneshot.py"),
        "superframe block-Toeplitz: shifted diagonal (banded off-by-one)"),
    Mutation(
        "go_audio_resampler_tpu_torch/engine/stages.py",
        "    cols = rel[..., None] + torch.arange(taps, device=hist.device)",
        "    cols = rel[..., None] + torch.arange(taps, device=hist.device) + 1",
        ("tests/test_torch_stages.py",),
        "banded streaming emit: coefficient placement off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/ops/convolve.py",
        "    r[ii * stride + tau, ii * f + ff] = kernels.to(device=device,",
        "    r[(ii * stride + tau + 1) % w, ii * f + ff] = kernels.to(\n"
        "        device=device,",
        ("tests/test_torch_oneshot.py",),
        "banded conv matrix: tap row off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/pipeline/fused.py",
        "    lam_c = max(0, -pos_min)",
        "    lam_c = max(0, -pos_min - 1)",
        ("tests/test_torch_pipeline_fused.py",),
        "compose: composite left context (lam_c) short by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/pipeline/fused.py",
        "        n_head = B.P * _ceil_div(A.n_head + B.lam, B.I)",
        "        n_head = B.P * ((A.n_head + B.lam) // B.I)",
        ("tests/test_torch_pipeline_fused.py",),
        "compose: aperiodic head reach floored instead of ceiled"),
    Mutation(
        "go_audio_resampler_tpu_torch/pipeline/fused.py",
        "            mA, rA = divmod(j, A.P)      # floored for j < 0",
        "            mA = math.trunc(j / A.P)     # floored for j < 0\n"
        "            rA = j - mA * A.P",
        ("tests/test_torch_pipeline_fused.py",),
        "compose: truncated instead of floored division for the "
        "left-context taps"),
    # --- the port's host-integer walk (no JAX counterpart: the JAX walk
    # runs in int32 limbs on the device) ---
    Mutation(
        "go_audio_resampler_tpu_torch/engine/stages.py",
        "         + (acc & 0xFFFF).to(dtype) * (1.0 / 65536.0)) * (1.0 / 65536.0)",
        "         + (acc & 0xFFFF).to(dtype) * (1.0 / 65600.0)) * (1.0 / 65536.0)",
        ("tests/test_torch_stages.py",),
        "walk32: wrong scale of the low fraction limb"),
    Mutation(
        "go_audio_resampler_tpu_torch/engine/stages.py",
        "    lo = at_lo + n * s_lo\n"
        "    return at_hi + n * q + (lo >> 16), lo & 0xFFFF",
        "    lo = at_lo + n * s_lo\n"
        "    return at_hi + n * q + (lo >> 17), lo & 0xFFFF",
        ("tests/test_torch_stages.py",),
        "_advance16: the fraction's carry into the integer part lost"),
]

CUDA_MUTATIONS = [
    Mutation(
        "go_audio_resampler_tpu_torch/ops/csrc/fused_resample.cu",
        "            off = s * ld + at - n_head;",
        "            off = s * ld + at - n_head + 1;",
        CUDA_TARGETS,
        "K1: frame start off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/ops/csrc/fused_resample_tmajor.cu",
        "    const float* slab = xt + frame * ipx * ld + s0;",
        "    const float* slab = xt + (frame * ipx + 1) * ld + s0;",
        CUDA_TARGETS,
        "K2: slab row off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/ops/csrc/general_resample.cu",
        "    const long long start = starts_are_64bit\n"
        "        ? __ldg(static_cast<const long long*>(starts) + t)\n"
        "        : (long long)__ldg(static_cast<const int*>(starts) + t);",
        "    const long long start = 1 + (starts_are_64bit\n"
        "        ? __ldg(static_cast<const long long*>(starts) + t)\n"
        "        : (long long)__ldg(static_cast<const int*>(starts) + t));",
        CUDA_TARGETS,
        "K3: window start off by one"),
    Mutation(
        "go_audio_resampler_tpu_torch/ops/csrc/banded_mma.cuh",
        "                wgmma_tf32(part, ahi[kk], b_desc(lo), 1);\n",
        "",
        CUDA_TARGETS,
        "K1/K2 3xTF32 product: the hi*lo cross term dropped"),
]


def source(mut: Mutation) -> pathlib.Path:
    """The file ``mut`` edits; raises unless it lies in the port's
    package (the JAX package and everything else are never touched)."""
    path = (REPO / mut.path).resolve()
    if PACKAGE not in path.parents:
        raise ValueError(f"mutation outside {PACKAGE.name}/: {mut.path}")
    return path


def test_files(mut: Mutation) -> list[pathlib.Path]:
    """The test files of ``mut``'s targets; raises unless each is a
    ``tests/test_torch_*.py`` file of the repo."""
    files = []
    for arg in mut.targets:
        path = REPO / arg.split("::")[0]
        if (path.parent != REPO / "tests" or not path.name.startswith(
                "test_torch_") or path.suffix != ".py"):
            raise ValueError(f"target is not a port test file: {arg}")
        files.append(path)
    return files


def _pytest(targets, options=()) -> tuple[bool, str]:
    """Run pytest on ``targets``, stopping at the first failure; returns
    whether every test passed and what pytest reported: the failing test
    (where one failed) and its last line."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-x", "-rf", "-p",
         "no:cacheprovider", *options, *targets], cwd=REPO,
        capture_output=True, text=True, timeout=TIMEOUT_S)
    lines = res.stdout.strip().splitlines() or [f"exit {res.returncode}"]
    failed = [ln.split(" - ")[0] for ln in lines if ln.startswith("FAILED ")]
    return res.returncode == 0, "; ".join(failed[:1] + lines[-1:])


def run(mut: Mutation, options=()) -> bool:
    """Apply one mutation, run its tests (with pytest's ``options``),
    restore.  True = caught."""
    src = source(mut)
    text = src.read_text()
    if text.count(mut.old) != 1:
        raise ValueError(f"mutation site is not unique: {mut.path}: "
                         f"{mut.old!r}")
    backup = src.with_name(src.name + BACKUP)
    shutil.copy(src, backup)
    try:
        src.write_text(text.replace(mut.old, mut.new, 1))
        passed, last = _pytest(mut.targets, options)
        print(f"{'SURVIVED' if passed else 'CAUGHT  '}  {mut.note}  "
              f"[{last}]", flush=True)
        return not passed
    finally:
        shutil.move(backup, src)


def restore_stragglers(root: pathlib.Path = PACKAGE) -> list[pathlib.Path]:
    """Put back any ``.mutbak`` left under ``root`` by a killed run;
    returns the files restored."""
    restored = []
    for bak in sorted(root.rglob(f"*{BACKUP}")):
        src = bak.with_name(bak.name[:-len(BACKUP)])
        shutil.move(bak, src)
        print(f"restored straggler {src}", file=sys.stderr)
        restored.append(src)
    return restored


def _interrupt(*_):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cuda", action="store_true",
                    help="run the CUDA kernels' mutants (needs a GPU and "
                         "nvcc) instead of the CPU set")
    ap.add_argument("filter", nargs="?",
                    help="select mutations whose path or note holds it")
    args = ap.parse_args(argv)

    # A SIGTERM mid-run (a time limit, a stopped task) would skip run()'s
    # finally and leave a live mutant in the tree: turn it into an
    # exception so the restore runs, and sweep any left by a killed run.
    signal.signal(signal.SIGTERM, _interrupt)
    restore_stragglers()
    muts = [m for m in (CUDA_MUTATIONS if args.cuda else MUTATIONS)
            if not args.filter or args.filter in m.path
            or args.filter in m.note]
    options = CUDA_OPTIONS if args.cuda else ()
    for mut in muts:
        source(mut)
        test_files(mut)
    targets = list(dict.fromkeys(t for m in muts for t in m.targets))
    passed, last = _pytest(targets, options)
    print(f"unmutated  {' '.join(targets)}  [{last}]", flush=True)
    if not passed:
        print("mutation check: the unmutated tree fails; no mutant can be "
              "judged")
        return 2
    ok = True
    for mut in muts:
        ok &= run(mut, options)
    print("mutation check:", "all caught" if ok else "SURVIVORS: add tests")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
