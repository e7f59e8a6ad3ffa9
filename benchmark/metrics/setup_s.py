"""Set-up seconds: building the pipeline (the port's own initialisation
and, in a fresh checkout, the kernels' build), loading the seeded weights,
making the clip pool and the warm-up calls (the sampler's capture)."""


def read(run):
    return run.setup_s
