"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  Prints what it
measured on earlier lines, the numbers its check compared beside their
limits as the last lines on standard error, and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``, then the
compared numbers under ``checks``.

Exits with another code than 0, and prints no result, where no card is
there (or fewer than the cell asks for), where the program cannot be
imported, and where JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level modules that no run may load: the JAX package beside the
#: port and JAX itself, compared whole (the port's name begins with the
#: JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "go_audio_resampler_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _caches() -> None:
    """The build and kernel caches at fixed places inside the checkout:
    the program builds its kernels into its own ``_build/`` there."""
    cache = ROOT / "portbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    # The checkout's root in place of this script's folder, whose modules
    # would otherwise shadow top-level names (``trace``).
    here = ROOT / "portbench"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    import torch

    from portbench import harness, manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    from portbench import costs
    print(f"card: {costs.nvidia_smi('name,power.limit')}; torch "
          f"{torch.__version__}, CUDA "
          f"{torch.version.cuda}; seed {args.seed}")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; a run loads neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
