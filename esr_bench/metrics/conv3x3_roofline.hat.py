"""``conv_tc_kernel``'s share of its roofline in a ``hat`` cell, over all
of HAT's 3x3 sites (``conv_tc_kernel_gelu``, the CABs' first conv, among
them): the sites' bounds summed per forward (``roofline_hat.
generator_convs``, at the padded LR and the published widths), times the
forwards whose launches the traced window holds, over the kernel's device
time summed. Moves ``eval_hr_mp_per_s``."""

from esr_bench import roofline, roofline_hat

UNIT = "%"


def read(ctx):
    if ctx.kind != "hat":
        return None
    times = [dur for name, _, dur in ctx.kernels if "conv_tc_kernel" in name]
    if not times:
        return None
    sites = roofline_hat.generator_convs(ctx.cfg, *ctx.counts["lr_shape"])
    forwards = len(times) / len(sites)
    bound = sum(roofline.bound_s(c.kernel_flops, c.bytes) for c in sites)
    return 100.0 * forwards * bound / (sum(times) / 1e6)
