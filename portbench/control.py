"""The readings that the check's limits are set from, on the card.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...]

In one process: the program as its configuration states it on each of
``--seeds`` (the lower readings), then the controls on each of
``--control-seeds``: the program at each precision tier below the
configuration's (``'high'``: three bf16 passes; ``'default'``: one), and
the reference computed in TF32 put in the program's place.  Each run is
the cell's own size and load with a window of ``--seconds``.  Prints one
JSON line per run and, last, for each mode and number compared, the
smallest and largest reading.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: The port's tiers below the configurations' 'highest' (float32-accurate):
#: three bf16 passes and one.
CONTROL_TIERS = ("high", "default")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    here = ROOT / "portbench"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    import torch

    from portbench import harness, manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if manifest.cell(args.workload).config["precision"] != "highest":
        raise ValueError("the controls are the tiers below 'highest'")
    runs = [(s, "program", {}) for s in args.seeds]
    for s in args.control_seeds:
        runs += [(s, t, {"tier": t}) for t in CONTROL_TIERS]
        runs.append((s, "tf32", {"control": "tf32"}))
    readings: dict = {}
    for seed, mode, kw in runs:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             log=lambda line: None, **kw)
        nums = {k: v["value"] for k, v in r["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": mode, "correct": r["correct"],
                          "attempted": r["attempted"], **nums}), flush=True)
        for k, v in nums.items():
            readings.setdefault(mode, {}).setdefault(k, []).append(v)
    print(json.dumps({m: {k: [min(v), max(v), len(v)] for k, v in d.items()}
                      for m, d in readings.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
