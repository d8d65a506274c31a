"""build_s: host seconds of the scenario build — the generator's spec, the
program's compile (`to_fleetsim`, its route layout and PathTable) and, on
a grid, its cells and `stack_scenarios` — from the harness's clock."""


def read(ctx):
    return ctx.get("build_s")
