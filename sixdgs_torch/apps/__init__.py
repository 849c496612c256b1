"""Command-line entry points of the port (``python -m sixdgs_torch.apps.<name>``)."""
