"""The channel attention's share of its roofline in a ``hat`` cell: its
two kernels (``ca_pool_kernel``, which ends in the squeeze, and
``ca_scale_kernel``, which writes the HAB's residual). The bound of one
call (``roofline_hat.channel_attn_bound_s``: the CAB's output and the
block's input read once and the residual written once, in bf16) times the
calls the port counted in the traced window's forwards (the
``channel_attn`` counter's deltas on its ``eval.forward`` roots), over the
two kernels' device time in the trace. Against a port without the kernels
or the counter, None. Moves ``eval_hr_mp_per_s``."""

from esr_bench import program, roofline_hat

UNIT = "%"


def read(ctx):
    recorded = program.spans() if ctx.kind == "hat" else None
    roots = program.window_roots(recorded or [], "eval.forward", ctx.units)
    calls = sum((r.counts or {}).get("channel_attn", 0) for r in roots)
    times = [dur for name, _, dur in ctx.kernels if "ca_pool_kernel" in name or "ca_scale_kernel" in name]
    if not calls or not times:
        return None
    bound = roofline_hat.channel_attn_bound_s(ctx.cfg, *ctx.counts["lr_shape"])
    return 100.0 * calls * bound / (sum(times) / 1e6)
