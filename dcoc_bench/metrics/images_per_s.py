"""``images_per_s``: images whose logits reached the host in the window,
over the window's seconds (host clock, from the first request's start to
the last one's end)."""


def read(run):
    if "images" not in run.obs:
        return None
    return run.obs["images"] / run.obs["window_s"]
