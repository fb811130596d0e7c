"""``moe_ms.<suffix>``: device milliseconds a traced decode step of the
kernels launched inside the program's ``moe`` spans (every MoE layer:
its norm, the router, the grouped dispatch of the routed experts and the
shared experts), attributed by the profiler's correlation ids.  Nothing
where the run traced no such span."""


def read(run):
    spans, n = run.obs.get("span_device_s"), run.obs.get("traced_steps")
    if not spans or not n or not spans.get("moe"):
        return None
    return 1e3 * spans["moe"] / n
