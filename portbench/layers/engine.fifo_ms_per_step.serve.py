"""Host time a step in the input FIFO's copies (``SampleFIFO.write`` and
each ``read``): the program's ``gar.engine.fifo`` spans, summed a step."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "gar.engine.fifo")
