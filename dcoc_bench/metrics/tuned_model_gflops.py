"""``tuned_model_gflops``: what the tuner produced, as the modelled
throughput of the tuned network.  The network's conv operations at the
tuned batch, summed over the window's sessions, over the sum of their
network latencies (multiplicity x best latency of each task) on the
analytical TPU v5e model.  A model output, never an H100 speed."""
from dcoc_bench.reference.networks import conv_layers


def read(run):
    sessions = run.obs.get("sessions")
    if not sessions:
        return None
    batch = run.mix["batch"]
    flops = sum(c.flops(batch) for c in conv_layers(run.config))
    latency = sum(r["best_latency"] * r["multiplicity"]
                  for s in sessions for r in s["reports"].values())
    return len(sessions) * flops / latency / 1e9
