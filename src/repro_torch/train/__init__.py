"""Training and serving: the train step builders (``steps``), checkpoints
(``checkpoint``), the fault-tolerant ``trainer`` and the continuous-batching
LM ``server``."""
