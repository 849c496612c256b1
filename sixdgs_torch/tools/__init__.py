"""Workflow tools of the port (``python -m sixdgs_torch.tools.<name>``)."""
