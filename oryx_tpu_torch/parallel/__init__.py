"""Parallelism for the port: meshes over ranks (mesh.py), the serving half
of the sharding rules (sharding.py) and the tensor-parallel ranks that run
them (tp.py). Imports neither jax nor the JAX package."""
