"""Command-line entry points of the pseudo-label pipeline (JAX ``cli/``):
``python -m samcarriestheburden_torch.cli.<name> --help``."""
