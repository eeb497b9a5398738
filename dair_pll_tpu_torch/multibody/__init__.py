"""Multibody model, batch-minor terms and the learnable system."""
