"""Architecture configs (copies of ``repro.configs``; the port imports
nothing of the JAX package)."""
