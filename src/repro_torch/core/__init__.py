"""Recommender: tile-space cost model and the SARA dispatcher."""
