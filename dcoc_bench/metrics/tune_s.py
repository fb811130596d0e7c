"""``tune_s``: seconds of one whole-network tuning session, all the time of
the window's sessions (each ended by a device synchronize) over their
count."""


def read(run):
    sessions = run.obs.get("sessions")
    if not sessions:
        return None
    return sum(s["seconds"] for s in sessions) / len(sessions)
