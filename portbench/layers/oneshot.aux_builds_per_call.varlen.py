"""Set-ups built a call: the program's ``gar.oneshot.aux`` spans a call, which
run only where ``functional``'s cache of them misses, so the cache's miss
ratio."""

from portbench.spans import mean_count


def read(run):
    return mean_count(run, "gar.oneshot.aux")
