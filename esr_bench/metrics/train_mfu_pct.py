"""The GAN step's model FLOP utilisation: ``roofline.gan_step_flops`` (G
forward and backward, VGG19 on SR with the input gradient and on HR, D on
the doubled batch in both updates; no recompute counted) times the steps
of the untraced window, over its wall time, as a share of 989 TFLOP/s
(bf16, dense). Moves ``train_step_ms``."""

from esr_bench import roofline

UNIT = "%"


def read(ctx):
    c = ctx.clean_counts
    if ctx.kind != "train" or not c["steps"]:
        return None
    flops = roofline.gan_step_flops(ctx.cfg, c["batch"], c["hr_size"]) * c["steps"]
    return 100.0 * flops / ctx.clean.window_s / roofline.PEAK_BF16_FLOPS
