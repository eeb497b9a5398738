"""Data pipeline: configs, dataset generation and slice management."""
