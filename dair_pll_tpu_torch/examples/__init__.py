"""Command-line experiments of the port, run as modules
(``python -m dair_pll_tpu_torch.examples.<name>``)."""
