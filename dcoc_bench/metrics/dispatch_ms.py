"""``dispatch_ms.<suffix>``: host milliseconds from a server step's call
to ``decode_step``'s return, before the server copies the tokens back
(which waits for the device), mean over every step of the window (the
profiler is off)."""


def read(run):
    enq = run.obs.get("enqueue_s")
    if not enq:
        return None
    return 1e3 * sum(enq) / len(enq)
