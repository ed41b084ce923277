"""Host time a call in the one-shot's set-up for a new length (design,
upload, ``banded.prepare``): the program's ``gar.oneshot.aux`` spans, summed a
call; 0 in a call whose set-up the cache held."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "gar.oneshot.aux")
