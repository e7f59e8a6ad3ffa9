"""Models of the PyTorch port (counterpart of ``v2ap_tpu.models``)."""
