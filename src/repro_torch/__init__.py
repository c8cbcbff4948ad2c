"""PyTorch + CUDA port of the SARA serving system (``src/repro`` is the
JAX reference).  Imports nothing of JAX or of ``repro``."""
