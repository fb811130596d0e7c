"""``step_mfu.<suffix>``: the share of its roofline a whole decode step
reaches.  Each traced step's least time on an H100 (``roofline_kda.py``:
the larger of its bytes over HBM's bandwidth and its operations over the
bf16 peak; the held routed experts counted by ``moe.experts_touched``,
their pairs by ``moe.pairs_elsewhere``, the latent cache at each slot's
context, the KDA states read and written), summed over the traced steps,
over the device's busy time in them.  Nothing without the counters."""
from dcoc_bench import roofline_kda


def read(run):
    t = run.devtrace
    contexts = run.obs.get("traced_contexts")
    touched = run.obs.get("experts_touched")
    elsewhere = run.obs.get("pairs_elsewhere")
    if t is None or not contexts or touched is None or elsewhere is None \
            or t.busy_s <= 0:
        return None
    cfg = run.config
    layers = len(contexts) * roofline_kda.moe_layers(cfg)
    pairs = len(contexts[0]) * cfg["num_experts_per_token"]
    held = pairs - float(elsewhere) / layers
    bound = sum(roofline_kda.step_bound_s(cfg, c, float(touched) / layers,
                                          held)
                for c in contexts)
    return 100.0 * bound / t.busy_s
