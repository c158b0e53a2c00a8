"""Data-parallel training over processes, one process per card
(`distributed.py`), and what is left of the JAX package's mesh (`mesh.py`)."""
