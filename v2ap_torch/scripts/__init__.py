"""Command-line probes of the PyTorch port (counterparts of ``scripts/``)."""
