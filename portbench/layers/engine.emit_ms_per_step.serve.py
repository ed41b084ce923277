"""Host time a step in the emit (the ramp drop, the canonical limit and the
``np.concatenate`` of the outputs): the program's ``gar.engine.emit`` spans,
summed a step."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "gar.engine.emit")
