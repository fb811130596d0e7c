"""``mappo_s``: self seconds of the ``mappo-update`` spans (the three
agents' MAPPO episodes against the surrogate, ``core/mappo.py`` and
``core/agents.py``) a session."""
from dcoc_bench.spans import per_session

SPAN = "mappo-update"


def read(run):
    return per_session(run, SPAN)
