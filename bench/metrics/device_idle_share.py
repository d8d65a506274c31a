"""device_idle_share: % of the traced stretch's host-clock length in
which no kernel ran on the device (1 - busy / wall)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["kernels"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
