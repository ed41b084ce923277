"""``latency_ms_p95`` in a cell whose time the host's work sets: the same
reading as ``latency_ms_p95``, under a name of its own for the reason that
``in_msamples_per_s.host`` gives."""

from portbench.end_to_end.latency_ms_p95 import read  # noqa: F401
