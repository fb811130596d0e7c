"""``measure_s``: self seconds of the ``measure`` spans (the oracle's
batched analytical measurements, ``compiler/oracle.py`` and
``hw/analytical.py``) a session.  A per-settings oracle records
``measure`` again inside its executor; self time counts each second
once."""
from dcoc_bench.spans import per_session

SPAN = "measure"


def read(run):
    return per_session(run, SPAN)
