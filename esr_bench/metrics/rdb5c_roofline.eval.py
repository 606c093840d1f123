"""``rdb5c_tc_kernel``'s share of its roofline in an eval cell: the bound
of one launch (``roofline.py``, from the configuration's widths and the
cell's batch) times the launches in the traced window, over their device
time. Moves ``eval_hr_mp_per_s``."""

from esr_bench import roofline

UNIT = "%"


def read(ctx):
    if ctx.kind != "eval":
        return None
    times = [dur for name, _, dur in ctx.kernels if "rdb5c_tc_kernel" in name]
    if not times:
        return None
    rdb = [c for c in roofline.generator_convs(ctx.cfg, *ctx.counts["lr_shape"]) if c.kernel == "rdb5c_tc_kernel"]
    return 100.0 * len(times) * roofline.bound_s(rdb[0].kernel_flops, rdb[0].bytes) / (sum(times) / 1e6)
