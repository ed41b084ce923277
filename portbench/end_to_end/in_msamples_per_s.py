"""Every input sample of every stream that the entry took in the window,
over the window: from the first request's call to the last one's end."""


def read(run):
    reqs = run.requests
    return sum(r.n_in for r in reqs) / (reqs[-1].t_done - reqs[0].t_call) / 1e6
