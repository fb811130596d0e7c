"""Optimizers (Adam with the reference's global-norm clip and cosine
schedule)."""
