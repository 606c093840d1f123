"""``window_attn_kernel``'s share of its roofline in an ``images`` cell:
the bound of one launch (``roofline_swinir.attention_bound_s``, bytes: q,
k, v read and the output written once in bf16) times the launches the port
counted in the traced window's forwards (the ``window_attn`` counter's
deltas on its ``eval.forward`` roots), over the kernel's device time in
the trace. Against a port without the kernel or the counter, None. Moves
``eval_hr_mp_per_s``."""

from esr_bench import program, roofline_swinir

UNIT = "%"


def read(ctx):
    recorded = program.spans() if ctx.kind == "images" else None
    roots = program.window_roots(recorded or [], "eval.forward", ctx.units)
    launches = sum((r.counts or {}).get("window_attn", 0) for r in roots)
    times = [dur for name, _, dur in ctx.kernels if "window_attn_kernel" in name]
    if not launches or not times:
        return None
    bound = roofline_swinir.attention_bound_s(ctx.cfg, *ctx.counts["lr_shape"])
    return 100.0 * launches * bound / (sum(times) / 1e6)
