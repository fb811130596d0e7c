"""``select_s``: self seconds a session of the spans that pick an
iteration's batch from the explored pool (``core/tuner.py`` and
``core/confidence_sampling.py``): the pool's dedup, the critic's scores
and Confidence Sampling."""
from dcoc_bench.spans import per_session

SPANS = ("pool-dedup", "critic-score", "confidence-sampling")


def read(run):
    found = [v for v in (per_session(run, s) for s in SPANS)
             if v is not None]
    return sum(found) if found else None
