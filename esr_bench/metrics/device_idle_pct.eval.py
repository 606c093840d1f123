"""The share of an eval cell's traced window in which the card ran no
kernel, copy or fill. The cell is bound by the card, whose queue of
forwards stays full however the profiler slows the host (a traced forward
takes within 0.5% of an untraced one). Moves ``eval_hr_mp_per_s``."""

UNIT = "%"


def read(ctx):
    if ctx.kind != "eval" or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
