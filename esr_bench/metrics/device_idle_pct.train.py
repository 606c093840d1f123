"""The share of the train cell's time in which the card runs no kernel,
copy or fill: one less the card's busy time a step, from the traced
window, over the wall time a step of the untraced window. The profiler
slows the host's launches by ~15-20% a step, so the traced window's own
idle share would overstate it. Moves ``train_step_ms``."""

UNIT = "%"


def read(ctx):
    if ctx.kind != "train" or ctx.busy_s <= 0 or not ctx.units or not ctx.clean.units:
        return None
    return 100.0 * (1.0 - (ctx.busy_s / ctx.units) / (ctx.clean.window_s / ctx.clean.units))
