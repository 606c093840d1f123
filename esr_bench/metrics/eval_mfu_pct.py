"""The eval forward's model FLOP utilisation: the generator's FLOPs as
published (``roofline.model_flops``; a x2 stage counted as nearest
upsample then a 3x3 conv; the CEM's matmuls not counted) times the forwards
of the untraced window, over its wall time, as a share of 989 TFLOP/s
(bf16, dense). Moves ``eval_hr_mp_per_s``."""

from esr_bench import roofline

UNIT = "%"


def read(ctx):
    if ctx.kind != "eval" or not ctx.clean_counts["forwards"]:
        return None
    flops = roofline.model_flops(ctx.cfg, *ctx.clean_counts["lr_shape"]) * ctx.clean_counts["forwards"]
    return 100.0 * flops / ctx.clean.window_s / roofline.PEAK_BF16_FLOPS
