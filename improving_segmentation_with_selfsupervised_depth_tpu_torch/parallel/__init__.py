"""Data-parallel training over N GPUs: the process group and the step's
collectives (`dist.py`), and the launcher that applies the JAX package's
rule and spawns one process per GPU (`launch.py`). The port's counterpart of
the JAX package's `parallel/mesh.py`; its `parallel/spatial.py` (spatially
sharded inference) is not ported yet."""
