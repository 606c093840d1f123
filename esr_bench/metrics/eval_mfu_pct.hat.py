"""The eval forward's model FLOP utilisation in a ``hat`` cell: HAT's
FLOPs as published (``roofline_hat.model_flops``, on the padded LR; the
CEM's matmuls not counted) times the forwards of the untraced window, over
its wall time, as a share of 989 TFLOP/s (bf16, dense). Moves
``eval_hr_mp_per_s``."""

from esr_bench import roofline, roofline_hat

UNIT = "%"


def read(ctx):
    if ctx.kind != "hat" or not ctx.clean_counts["forwards"]:
        return None
    flops = roofline_hat.model_flops(ctx.cfg, *ctx.clean_counts["lr_shape"]) * ctx.clean_counts["forwards"]
    return 100.0 * flops / ctx.clean.window_s / roofline.PEAK_BF16_FLOPS
