"""Command-line tools of the port: `python -m lushnerf_torch.scripts.<name>`."""
