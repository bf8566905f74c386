"""Command-line entry points of the port: ``python -m
variational_mmt_torch.cli.train`` and ``python -m
variational_mmt_torch.cli.translate``."""
