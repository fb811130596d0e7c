"""``untraced_s``: self seconds of the ``session`` spans a session, the
session's time that none of its child spans covers
(``compiler/session.py``)."""
from dcoc_bench.spans import per_session

SPAN = "session"


def read(run):
    return per_session(run, SPAN)
