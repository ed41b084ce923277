"""From the start of the process until the first timed request."""


def read(run):
    return run.setup_s
