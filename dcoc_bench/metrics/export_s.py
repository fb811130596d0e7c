"""``export_s``: self seconds of the ``forest-export`` spans (the GBT's
forest copied to the card before an iteration's episodes,
``core/cost_model.py``) a session."""
from dcoc_bench.spans import per_session

SPAN = "forest-export"


def read(run):
    return per_session(run, SPAN)
