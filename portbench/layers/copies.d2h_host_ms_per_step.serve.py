"""Host time a step in the device-to-host copy of the output
(``.cpu().numpy()``), with its wait for the step's kernels: the program's
``gar.engine.d2h`` spans, summed a step."""

from portbench.spans import mean_ms


def read(run):
    return mean_ms(run, "gar.engine.d2h")
