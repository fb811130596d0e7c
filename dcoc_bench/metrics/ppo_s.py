"""``ppo_s``: self seconds of the ``mappo-ppo`` spans (each MAPPO
episode's GAE and PPO epochs with their Adam steps, ``core/mappo.py`` and
``optim/adam.py``) a session."""
from dcoc_bench.spans import per_session

SPAN = "mappo-ppo"


def read(run):
    return per_session(run, SPAN)
