"""Training runtime: the fault-tolerant step driver."""
