"""``token_linear_kernel``'s share of its roofline in an ``images`` cell:
the bound of the launches the port counted in the traced window's forwards
(the ``token_linear`` counter's deltas on its ``eval.forward`` roots), over
the kernel's device time in the trace (cuBLAS's GEMMs are not it).

A Swin block runs four linears, qkv C -> 3C, proj C -> C, fc1 C -> rC and
fc2 rC -> C (r the MLP ratio), and each launch is bounded as its share of
the block's four: per padded LR token and block the launches read the
tokens and the residual and write their outputs once in bf16, 2 x (4C + 3C
+ 3C + 4C) = 28 C bytes (5,040 at C 180; the weights, held on chip, not
counted, so the bound stays a lower bound), against 2 (4 C^2 + 2 C rC) FLOP
(518,400), whichever bounds: bytes. Against a port without the kernel or
the counter, None. Moves ``eval_hr_mp_per_s``."""

from esr_bench import program, roofline, roofline_swinir

UNIT = "%"
LAUNCHES_A_BLOCK = 4


def block_bytes(cfg: dict) -> float:
    """Bytes of one block's four linears a padded token: inputs, residuals and outputs once, bf16."""
    return 2.0 * 14 * cfg["network_G"]["embed_dim"]


def block_flops(cfg: dict) -> float:
    """FLOPs of one block's four linears a padded token."""
    g = cfg["network_G"]
    c = g["embed_dim"]
    return 2.0 * (4 * c * c + 2 * c * int(g["mlp_ratio"] * c))


def block_bound_s(cfg: dict, n: int, h: int, w: int) -> float:
    """The least time one Swin block's four linears could take on the H100."""
    hp, wp = roofline_swinir.padded(cfg, h, w)
    tokens = float(n * hp * wp)
    return roofline.bound_s(block_flops(cfg) * tokens, block_bytes(cfg) * tokens)


def read(ctx):
    recorded = program.spans() if ctx.kind == "images" else None
    roots = program.window_roots(recorded or [], "eval.forward", ctx.units)
    launches = sum((r.counts or {}).get("token_linear", 0) for r in roots)
    times = [dur for name, _, dur in ctx.kernels if "token_linear_kernel" in name]
    if not launches or not times:
        return None
    bound = launches / LAUNCHES_A_BLOCK * block_bound_s(ctx.cfg, *ctx.counts["lr_shape"])
    return 100.0 * bound / (sum(times) / 1e6)
