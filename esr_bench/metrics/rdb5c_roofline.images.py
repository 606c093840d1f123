"""``rdb5c_tc_kernel``'s share of its roofline in an ``images`` cell: the
bound of one launch at the image's own LR size (``roofline.py``, the
configuration's widths and the cell's batch; the tiles beyond the ragged
edges are not work) times the launches the port counted in the traced
window's forwards (the ``rdb5c`` counter's deltas on its ``eval.forward``
roots), over the kernel's device time in the trace. Moves
``eval_hr_mp_per_s``."""

from esr_bench import program, roofline

UNIT = "%"


def read(ctx):
    recorded = program.spans() if ctx.kind == "images" else None
    roots = program.window_roots(recorded or [], "eval.forward", ctx.units)
    launches = sum((r.counts or {}).get("rdb5c", 0) for r in roots)
    times = [dur for name, _, dur in ctx.kernels if "rdb5c_tc_kernel" in name]
    if not launches or not times or ctx.cfg["network_G"]["which_model_G"] != "RRDB_net":
        return None
    rdb = [c for c in roofline.generator_convs(ctx.cfg, *ctx.counts["lr_shape"]) if c.kernel == "rdb5c_tc_kernel"]
    return 100.0 * launches * roofline.bound_s(rdb[0].kernel_flops, rdb[0].bytes) / (sum(times) / 1e6)
