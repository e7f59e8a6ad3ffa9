"""v2ap_torch — the PyTorch / CUDA port of v2ap_tpu for NVIDIA Hopper.

Grows slice by slice beside the JAX package, which stays the reference.
Serving: ``v2ap_torch.pipelines.generate.V2APipeline`` (V2A and V2P, with
or without a prompt; ``generate``, ``generate_batch``, ``passes``), long
videos (``pipelines.merge``), the HTTP server (``serving``, ``python -m
v2ap_torch.app``) and the ``Predictor``; on the card the sampler runs as
one captured CUDA graph per shape (``utils.jitting``). Training, V2A and
V2P: from corpora (``data``) through ``training.pipeline.TrainingPipeline``
(``python -m v2ap_torch.train``) to checkpoints (``utils.checkpoint``)
that serving loads (``V2APipeline.load_weights``). Attention runs the
hand-written CUDA kernels of ``v2ap_torch/csrc/``.
"""
