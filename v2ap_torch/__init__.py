"""v2ap_torch — the PyTorch / CUDA port of v2ap_tpu for NVIDIA Hopper.

Grows slice by slice beside the JAX package, which stays the reference.
This slice: V2A serving with an empty prompt — CLIP ViT-bigG over decoded
frames, the 25-step CFG flow sampler over the tri-stream transformer, and
EnCodec decode (``v2ap_torch.pipelines.generate.V2APipeline``). Attention
runs a hand-written CUDA kernel (``v2ap_torch/csrc/flash_fwd.cu``).
"""
