"""``in_msamples_per_s`` in a cell whose time the host's work sets (numpy
in and out a step): the same reading as ``in_msamples_per_s``, under a
name of its own because such a cell spreads several times as widely
between runs as the card's cells, and one bound holds a metric in every
cell that reports it."""

from portbench.end_to_end.in_msamples_per_s import read  # noqa: F401
