"""The eval forward's model FLOP utilisation in an ``images`` cell: the
generator's FLOPs as published (``roofline_swinir.model_flops`` for SwinIR,
on the padded LR; ``roofline.model_flops`` for the others; the CEM's
matmuls not counted) times the forwards of the untraced window, over its
wall time, as a share of 989 TFLOP/s (bf16, dense). Moves
``eval_hr_mp_per_s``."""

from esr_bench import roofline, roofline_swinir

UNIT = "%"


def read(ctx):
    if ctx.kind != "images" or not ctx.clean_counts["forwards"]:
        return None
    count = roofline_swinir if roofline_swinir.is_swinir(ctx.cfg) else roofline
    flops = count.model_flops(ctx.cfg, *ctx.clean_counts["lr_shape"]) * ctx.clean_counts["forwards"]
    return 100.0 * flops / ctx.clean.window_s / roofline.PEAK_BF16_FLOPS
