"""Data-parallel training and rollouts over ``torch.distributed``, and
cross-process trial coordination."""
