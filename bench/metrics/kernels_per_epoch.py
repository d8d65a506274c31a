"""kernels_per_epoch: device kernels the traced stretch ran, per epoch."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["kernels"] or not tr["epochs"]:
        return None
    return len(tr["kernels"]) / tr["epochs"]
