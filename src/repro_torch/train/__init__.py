"""Serving: the continuous-batching LM ``server``."""
