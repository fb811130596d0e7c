"""``fwd_mfu.<suffix>``: the whole forward's share of the card's peak
over the window: the operations of the images served (every conv and the
head, ``roofline.py``) over the window's seconds (host clock, the
profiler off, copies both ways included), over the peak of the
configured dtype."""
from dcoc_bench import roofline


def read(run):
    if not run.obs.get("images"):
        return None
    per_image = roofline.forward_flops(run.config, 1)
    rate = run.obs["images"] * per_image / run.obs["window_s"]
    return 100.0 * rate / roofline.PEAK_FLOPS[run.config["dtype"]]
