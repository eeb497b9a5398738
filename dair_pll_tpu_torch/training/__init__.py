"""Training: experiment configs, the supervised learning loop and the
multibody experiment."""
