"""``refit_s``: self seconds of the ``surrogate-refit`` spans (the GBT
cost model's refit on the host, ``core/cost_model.py``) a session."""
from dcoc_bench.spans import per_session

SPAN = "surrogate-refit"


def read(run):
    return per_session(run, SPAN)
