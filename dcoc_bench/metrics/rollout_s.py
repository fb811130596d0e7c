"""``rollout_s``: self seconds of the ``mappo-rollout`` spans (each MAPPO
episode's rollout: the agents' policy steps and the surrogate's reward on
the card, ``core/mappo.py``) a session."""
from dcoc_bench.spans import per_session

SPAN = "mappo-rollout"


def read(run):
    return per_session(run, SPAN)
