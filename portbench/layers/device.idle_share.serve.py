"""The share of the traced window in which no kernel or copy ran."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)
