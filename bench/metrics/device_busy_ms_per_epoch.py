"""device_busy_ms_per_epoch: the union of the traced kernels' intervals,
in ms, per epoch."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["kernels"] or not tr["epochs"]:
        return None
    return tr["busy_s"] * 1e3 / tr["epochs"]
