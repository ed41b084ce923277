"""The port's examples: one module per script of the JAX repo's
``examples/``, each showing one user workflow on the card.

Each module has ``main(device='cuda')``, which prints what its JAX
counterpart prints, keeps its asserts and returns the values it printed
(arrays on the host, lengths, losses) in a dict.  Run one with

    python -m go_audio_resampler_tpu_torch.examples.<name> [--device cpu]

(on the card by default; ``--device cpu`` runs the kernels' plain
versions).
"""

from __future__ import annotations

import argparse

NAMES = ("basic", "device_serving", "hq_and_time_major",
         "ml_ingest_training", "sharded", "variable_rate")


def run(main, doc: str) -> None:
    """Parse ``--device`` and call ``main(device=...)``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card)")
    main(device=ap.parse_args().device)
