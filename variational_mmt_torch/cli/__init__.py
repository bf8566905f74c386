"""Command-line entry points of the port: ``python -m
variational_mmt_torch.cli.train``, ``.cli.translate`` and ``.cli.serve``."""
