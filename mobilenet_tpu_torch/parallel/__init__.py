"""Data, tensor and pipeline parallelism over a grid of devices driven by one
process: the port of the JAX package's `parallel/` (mesh.py, tp_fused.py,
pp.py). Imports nothing at package import."""
