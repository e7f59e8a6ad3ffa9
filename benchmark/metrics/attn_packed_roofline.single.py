"""K1's share of its roofline (%): the least time the flow model's
attention of the traced calls needs (``counts.attention_bound`` over every
layer's calls of every CFG evaluation) over the device time of the d-64
tensor-core flash forward kernels in the trace. Only cells whose other
work launches no d-64 flash forward list it (ViT-L/14-336 does)."""

from benchmark.readers import packed_attention_least_s, roofline_pct

KERNELS = ("flash_fwd_sm90_kernel<64>",)


def read(run):
    return roofline_pct(run, KERNELS, packed_attention_least_s(run))
