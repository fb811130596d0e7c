"""``mla_ms.<suffix>``: device milliseconds a traced decode step of the
kernels launched inside the program's ``mla`` spans (every layer's
latent attention: norms, projections, rope, the latent cache's write and
the absorbed attention), attributed by the profiler's correlation ids.
Nothing where the run traced no such span."""


def read(run):
    spans, n = run.obs.get("span_device_s"), run.obs.get("traced_steps")
    if not spans or not n or not spans.get("mla"):
        return None
    return 1e3 * spans["mla"] / n
