"""``conv_tc_kernel``'s share of its roofline in an ``images`` cell, over
all its sites (3x3 and the 2x2 parity mode): the sites' bounds summed per
forward (``roofline_swinir.generator_convs`` for SwinIR, at the padded LR;
``roofline.generator_convs`` for the others, at the image's own LR, the
tiles beyond the ragged edges not work), times the forwards whose launches
the traced window holds, over the kernel's device time summed. Moves
``eval_hr_mp_per_s``."""

from esr_bench import roofline, roofline_swinir

UNIT = "%"


def read(ctx):
    if ctx.kind != "images":
        return None
    times = [dur for name, _, dur in ctx.kernels if "conv_tc_kernel" in name]
    if not times:
        return None
    count = roofline_swinir if roofline_swinir.is_swinir(ctx.cfg) else roofline
    sites = [c for c in count.generator_convs(ctx.cfg, *ctx.counts["lr_shape"]) if c.kernel == "conv_tc_kernel"]
    forwards = len(times) / len(sites)
    bound = sum(roofline.bound_s(c.kernel_flops, c.bytes) for c in sites)
    return 100.0 * forwards * bound / (sum(times) / 1e6)
