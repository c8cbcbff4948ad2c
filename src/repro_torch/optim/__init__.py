"""Optimizers on parameter dicts of tensors."""
