"""Host time a step in the host-to-device copy of the block
(``EngineCore._to_device``): the program's ``gar.engine.h2d`` spans, summed a
step."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "gar.engine.h2d")
