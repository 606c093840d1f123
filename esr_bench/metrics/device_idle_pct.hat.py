"""The share of a ``hat`` cell's traced window in which the card ran no
kernel, copy or fill. Moves ``eval_hr_mp_per_s``."""

UNIT = "%"


def read(ctx):
    if ctx.kind != "hat" or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
