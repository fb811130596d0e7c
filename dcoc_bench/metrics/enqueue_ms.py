"""``enqueue_ms.<suffix>``: host milliseconds from a forward's call to
its return, before the logits are copied back (which waits for the
device), mean over every request of the window (the profiler is off)."""


def read(run):
    enq = run.obs.get("enqueue_s")
    if not enq:
        return None
    return 1e3 * sum(enq) / len(enq)
