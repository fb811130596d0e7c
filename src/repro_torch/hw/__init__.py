"""The analytical TPU v5e model the tuner measures against (not a model of the H100)."""
