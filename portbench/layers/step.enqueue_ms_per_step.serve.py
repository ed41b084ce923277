"""Host time a step in the step's enqueue (the carry's ``cat``, the kernel
launch, the slices): the program's ``gar.engine.step`` spans, summed a step."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "gar.engine.step")
