"""link_scatter_roofline: % of the HBM roofline reached by the kernels
that compute the flow -> link offered load (kernel_work/link_scatter.json),
its bytes by the frozen formula of `bench.harness.work`."""
from bench.harness.work import roofline


def read(ctx):
    return roofline(ctx, "link_scatter")
