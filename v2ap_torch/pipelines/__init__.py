"""Generation pipelines of the PyTorch port."""
