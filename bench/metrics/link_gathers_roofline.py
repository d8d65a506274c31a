"""link_gathers_roofline: % of the HBM roofline reached by the kernels
that compute the link -> flow min / product / sum gathers
(kernel_work/link_gathers.json), bytes by `bench.harness.work`."""
from bench.harness.work import roofline


def read(ctx):
    return roofline(ctx, "link_gathers")
