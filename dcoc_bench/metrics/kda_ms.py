"""``kda_ms.<suffix>``: device milliseconds a traced decode step of the
kernels launched inside the program's ``kda`` spans (every KDA layer:
its norm, projections, short convs, gates, the KDA decode kernel on the
state, the output norm and W_o), attributed by the profiler's
correlation ids.  Nothing where the run traced no such span."""


def read(run):
    spans, n = run.obs.get("span_device_s"), run.obs.get("traced_steps")
    if not spans or not n or not spans.get("kda"):
        return None
    return 1e3 * spans["kda"] / n
