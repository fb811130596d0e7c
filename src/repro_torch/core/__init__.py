"""ARCO core: design space, GBT cost model, MAPPO agents, Confidence Sampling, the tuning loop."""
