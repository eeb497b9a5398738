"""Tensor, quaternion, batch-minor (SoA) solver and kernel modules."""
