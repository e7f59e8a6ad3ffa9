"""K2's share of its roofline (%): the least time ViT-bigG's attention over
the traced calls' encoded frames needs over the device time of the d-104
tensor-core flash forward kernels in the trace."""

from benchmark.readers import roofline_pct, vit_attention_least_s

KERNELS = ("flash_fwd_sm90_kernel<104>",)


def read(run):
    return roofline_pct(run, KERNELS, vit_attention_least_s(run, "clip_vit"))
