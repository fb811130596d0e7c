"""``idle_pct.<suffix>``: the share of the traced window in which no
device activity ran: 100 x (1 - union of the device intervals / the
window), from the profiler's trace."""


def read(run):
    t = run.devtrace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
