"""HTTP serving of the PyTorch port: the request batcher, the server and its demo clips."""
