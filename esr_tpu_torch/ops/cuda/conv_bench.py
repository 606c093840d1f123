"""Time the kernels alone, beside their plain versions, the library calls and
their bounds: the conv kernel at the flagship forward's six conv sites, at
SRResNet's two 64 -> 256 upconvs and at 128 -> 128 in both modes, and the
fused RDB kernel; in bf16, or with ``--f32`` the f32 route (the flagship's
six sites, Cin 256 and the RDB as five f32 conv launches). The bf16 run adds
SwinIR-M's kernels at the ``swinir_eval_div2k_b4`` cell's padded shape
(``SWIN``): its two 180-channel convs, ``window_attn_kernel`` (shift 4),
``layernorm_kernel`` and ``token_linear_kernel`` at a Swin block's four
linear sites (``SWIN_LINEARS``).

    python -m esr_tpu_torch.ops.cuda.conv_bench [--f32 | --widths | --tiles]

Each conv site (B16) runs through ``conv_launch``, the RDB (B16 x 128 x 128
x 64, nf 64, gc 32) through ``rdb5c_launch``, each with its weight layout
built once, as the forward runs it: CUDA events around 20 back-to-back
launches, median of 5 windows, ms per launch. One row a site: the kernel's
ms, its plain version's (``conv3x3_reference`` / ``rdb5c_reference`` in the
kernel's dtype), the library call's (``F.conv2d`` on the channels-last
input; 2x2 mode: ``F.conv_transpose2d`` with the folded 4x4 weight; bf16
``F.layer_norm`` for the LayerNorm; for a linear its plain version,
``F.linear`` then ``F.gelu`` or the residual add; none for the RDB and the
attention) and
the bound (:func:`bound`), TF32 off. Then one line, ``BENCH
[f32] card | site ms | ... | rdb5c ms``, so that kernel versions built in
turns on one card can be compared. ``--widths`` times the bf16 RDB at the
other widths of ``WIDTHS`` on B16 x 128 x 128 x nf instead (5 launches a
window, 3 windows), beside its plain version and the bound of the unpadded
work. ``--tiles`` times each nf 64 / gc 32 tile of the bf16 RDB at the grids
of ``TILE_SHAPES`` (20 launches captured in a CUDA graph, as the graphed
forwards and Z steps run them, so that no host time between launches
counts; median of 5 replays) beside the tile ``rdb5c_tile`` picks and the
bound. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import statistics

import torch
import torch.nn.functional as F

from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference, conv_kernel_weights, conv_launch
from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_kernel_weights, rdb5c_launch, rdb5c_reference
from esr_tpu_torch.ops.fused import upsample2x_conv3x3_reference

# H100 SXM published dense peaks (NVIDIA H100 datasheet): bf16 tensor cores,
# f32 outside the tensor cores (the f32 route's bound) and HBM3. Bounds are
# stated against these whatever the power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# (site, input edge, Cin, Cout, ksize): the flagship's conv_first,
# trunk_conv, HRconv and conv_last in 3x3 mode and its two upsample convs in
# 2x2 mode; SRResNet x4's upconvs (3x3, Cout in four slices); 128 -> 128 (two
# K chunks, two slices) in both modes
SITES = (("conv_first", 128, 4, 64, 3), ("trunk_conv", 128, 64, 64, 3), ("HRconv", 512, 64, 64, 3),
         ("conv_last", 512, 64, 3, 3), ("upconv1", 128, 64, 64, 2), ("upconv2", 256, 64, 64, 2),
         ("sr_upconv1", 128, 64, 256, 3), ("sr_upconv2", 256, 64, 256, 3), ("wide128", 128, 128, 128, 3),
         ("wide128_up", 128, 128, 128, 2))
# SwinIR-M x4 at the swinir_eval_div2k_b4 cell: B4 x LR 339 x 510, padded to
# the 8 x 8 window's multiple; 180 channels, 6 heads
SWIN, SWIN_C, SWIN_HEADS, SWIN_WS = (4, 344, 512), 180, 6, 8
# (site, Cout, LeakyReLU slope or None): the RSTBs' convs and conv_after_body,
# and conv_before_upsample
SWIN_CONVS = (("swin_conv", 180, None), ("swin_conv_up", 64, 0.01))
# (site, K, N, GELU, residual): a Swin block's linears, attn.qkv, attn.proj,
# mlp.fc1 and mlp.fc2, with their epilogues
SWIN_LINEARS = (("linear_qkv", 180, 540, False, False), ("linear_proj", 180, 180, False, True),
                ("linear_fc1", 180, 360, True, False), ("linear_fc2", 360, 180, False, True))
# the f32 route: the flagship's six sites and a Cin the earlier f32 kernel
# could not hold (256 -> 64 at 128)
F32_SITES = SITES[:6] + (("cin256", 128, 256, 64, 3),)
# (nf, gc) of the bf16 RDBs other than the flagship's 64 / 32: the JAX
# package's kernel test's width, and one width of each other instance
WIDTHS = ((16, 8), (32, 16), (128, 64))
# (n, h, w) of the RDB at nf 64 / gc 32 for --tiles: the editor's Z step crop
# and render, serving's B2 x LR 64, the GAN step's G forward, B4 x 64^2 and the
# eval batch
TILE_SHAPES = ((1, 64, 64), (1, 128, 128), (2, 64, 64), (16, 32, 32), (4, 64, 64), (16, 128, 128))


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least ms that ``flops`` operations and ``nbytes`` of memory traffic
    take at the peaks, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def conv_bound(px: int, cin: int, cout: int, ksize: int, esize: int, peak_flops: float) -> tuple[float, str]:
    """A conv over ``px`` input pixels: 9 (3x3) or 16 (2x2 mode, the four
    parities' 2x2 taps) MACs a channel pair and input pixel; the input read
    and the output (4x the pixels in 2x2 mode) written once, and the weights."""
    taps, up = (9, 1) if ksize == 3 else (16, 4)
    return bound(2 * taps * cin * cout * px, esize * (px * (cin + up * cout) + taps * cin * cout), peak_flops)


def rdb_bound(n: int, h: int, w: int, nf: int, gc: int, esize: int, peak_flops: float = PEAK_BF16_FLOPS):
    """An RDB at B``n`` x ``h`` x ``w``: its five convs' MACs; x read and the
    output written once, and the weights (f32 biases)."""
    px = n * h * w
    macs = 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)
    return bound(2 * macs * px, 2 * esize * px * nf + macs * esize + (4 * gc + nf) * 4, peak_flops)


def convT_weight(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO 3x3 kernel -> the (Cin, Cout, 4, 4) weight of
    ``F.conv_transpose2d(x, ., stride=2, padding=1)``, which computes
    ``conv3x3(SAME)(nearest_2x(x))``: transposed tap k of output parity a
    reads x[m + (a + 1 - k) / 2], so the 3 taps fold onto 4 as below."""
    fold = kernel.new_tensor([[0, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0]])
    return torch.einsum("ka,lb,abio->iokl", fold, fold, kernel)


def launch_ms(fn, reps: int = 20, windows: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """ms per call of ``fn``, ``reps`` calls captured in one CUDA graph,
    median of ``windows`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def measured(name: str, kernel: str, shape: str, ms: float, plain_ms: float, library_ms: float | None,
             b: tuple[float, str]) -> dict:
    """One row: a site of the kernel whose launch counter is named ``kernel``."""
    return {"name": name, "kernel": kernel, "shape": shape, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b[0], "bound_by": b[1]}


def text(r: dict) -> str:
    lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    return (f"{r['name']:<12s} {r['shape']:<26s} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib_ms}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%)")


def bench_sites(g: torch.Generator, f32: bool) -> tuple[list[dict], list[str]]:
    """Each conv site's row and the RDB's (and in bf16 SwinIR's), and the
    BENCH line's fields."""
    dtype, esize, peak = (torch.float32, 4, PEAK_F32_FLOPS) if f32 else (torch.bfloat16, 2, PEAK_BF16_FLOPS)
    rows, fields = [], []
    for site, s, cin, cout, ksize in F32_SITES if f32 else SITES:
        x = torch.randn(16, s, s, cin, device="cuda", generator=g).to(dtype)
        w = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        b = torch.zeros(cout, device="cuda")
        kw = conv_kernel_weights(w, b, dtype, x.device, ksize)
        xc, bc = x.permute(0, 3, 1, 2), b.to(dtype)
        if ksize == 3:
            plain, wc = conv3x3_reference, w.permute(3, 2, 0, 1).to(dtype)
            library = lambda: F.conv2d(xc, wc, bc, padding=1)  # noqa: E731
        else:
            plain, wc = upsample2x_conv3x3_reference, convT_weight(w).to(dtype)
            library = lambda: F.conv_transpose2d(xc, wc, bc, stride=2, padding=1)  # noqa: E731
        ms = launch_ms(lambda: conv_launch(x, kw, True))
        kernel = ("conv3x3" if ksize == 3 else "upsample2x_conv3x3") + "_f32" * f32
        rows.append(measured(site, kernel, f"B16 {s}x{s} {cin}->{cout}" + " 2x2" * (ksize == 2), ms,
                             launch_ms(lambda: plain(x, w, b, True), reps=3, windows=3),
                             launch_ms(library, reps=3, windows=3),
                             conv_bound(16 * s * s, cin, cout, ksize, esize, peak)))
        fields.append(f"{site} {ms:.4f}")
        del x, kw, xc, wc
    x = torch.randn(16, 128, 128, 64, device="cuda", generator=g).to(dtype)
    params = kaiming_rdb_weights(64, 32, g)
    kw = rdb5c_kernel_weights(params, dtype, x.device)
    ms = launch_ms(lambda: rdb5c_launch(x, kw))
    rows.append(measured("rdb5c", "rdb5c" + "_f32" * f32, "x (16,128,128,64)", ms,
                         launch_ms(lambda: rdb5c_reference(x, params), reps=3, windows=3), None,
                         rdb_bound(16, 128, 128, 64, 32, esize, peak)))
    fields.append(f"rdb5c {ms:.4f}")
    del x, kw
    if not f32:
        swin_rows = bench_swinir(g)
        rows += swin_rows
        fields += [f"{r['name']} {r['ms']:.4f}" for r in swin_rows]
    return rows, fields


def bench_swinir(g: torch.Generator) -> list[dict]:
    """SwinIR-M's bf16 kernels at ``SWIN``: the Cin 129-192 conv instances
    (180 -> 180, and 180 -> 64 with LeakyReLU(0.01)), the window attention
    with the shifted windows' mask (its bound from q, k, v read and the output
    written once, 4 x 64 x 180 FLOP a token), the LayerNorm (each token read
    and written once) and the linears with their epilogues (the tokens and the
    residual read and the output written once, 2 K N FLOP a token; the
    weights, held on chip, not counted)."""
    from esr_tpu_torch.ops.cuda.layernorm import layer_norm, layer_norm_reference
    from esr_tpu_torch.ops.cuda.token_linear import token_linear_launch, token_linear_reference, token_linear_weights
    from esr_tpu_torch.ops.cuda.window_attn import window_attention, window_attention_reference

    c, px = SWIN_C, SWIN[0] * SWIN[1] * SWIN[2]
    shape = "B{} {}x{}".format(*SWIN)
    rows = []
    for site, cout, slope in SWIN_CONVS:
        x = torch.randn(*SWIN, c, device="cuda", generator=g).bfloat16()
        w = torch.randn(3, 3, c, cout, device="cuda", generator=g) * (2.0 / (9 * c)) ** 0.5
        b = torch.zeros(cout, device="cuda")
        kw = conv_kernel_weights(w, b, torch.bfloat16, x.device)
        act = slope is not None
        xc, wc, bc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).bfloat16(), b.bfloat16()
        rows.append(measured(site, "conv3x3", f"{shape} {c}->{cout}" + f" lrelu {slope}" * act,
                             launch_ms(lambda: conv_launch(x, kw, act, 0.01)),
                             launch_ms(lambda: conv3x3_reference(x, w, b, act, 0.01), reps=3, windows=3),
                             launch_ms(lambda: F.conv2d(xc, wc, bc, padding=1), reps=3, windows=3),
                             conv_bound(px, c, cout, 3, 2, PEAK_BF16_FLOPS)))
        del x, kw, xc
    qkv = torch.randn(*SWIN, 3 * c, device="cuda", generator=g).bfloat16()
    bias = torch.randn(SWIN_HEADS, SWIN_WS**2, SWIN_WS**2, device="cuda", generator=g)
    attn = (qkv, bias, SWIN_HEADS, SWIN_WS, SWIN_WS // 2)
    rows.append(measured("window_attn", "window_attn", f"qkv {shape} {3 * c} shift {SWIN_WS // 2}",
                         launch_ms(lambda: window_attention(*attn)),
                         launch_ms(lambda: window_attention_reference(*attn), reps=3, windows=3), None,
                         bound(4.0 * SWIN_WS**2 * c * px, 2.0 * 4 * c * px)))
    del qkv, attn
    x = (torch.randn(*SWIN, c, device="cuda", generator=g) * 2 + 0.3).bfloat16()
    w = (1 + 0.2 * torch.randn(c, device="cuda", generator=g)).bfloat16()
    b = (0.1 * torch.randn(c, device="cuda", generator=g)).bfloat16()
    rows.append(measured("layernorm", "layernorm", f"{shape} {c}", launch_ms(lambda: layer_norm(x, w, b, 1e-5)),
                         launch_ms(lambda: layer_norm_reference(x, w, b, 1e-5), reps=3, windows=3),
                         launch_ms(lambda: F.layer_norm(x, (c,), w, b, 1e-5), reps=3, windows=3),
                         bound(8.0 * c * px, 2.0 * 2 * c * px)))
    del x
    for site, k, n, gelu, res in SWIN_LINEARS:
        x = torch.randn(px, k, device="cuda", generator=g).bfloat16()
        w = (torch.randn(n, k, device="cuda", generator=g) * k**-0.5).bfloat16()
        b = (0.1 * torch.randn(n, device="cuda", generator=g)).bfloat16()
        r = (2 * torch.randn(px, n, device="cuda", generator=g)).bfloat16() if res else None
        kw = token_linear_weights(w, b)
        epi = "gelu" if gelu else "residual" if res else "bias"
        # the plain version is the library chain the kernel replaced: one timing for both columns
        plain_ms = launch_ms(lambda: token_linear_reference(x, w, b, gelu, r), reps=3, windows=3)
        rows.append(measured(site, "token_linear", f"{shape} {k}->{n} {epi}",
                             launch_ms(lambda: token_linear_launch(x, kw, gelu, r)), plain_ms, plain_ms,
                             bound(2.0 * k * n * px, 2.0 * px * (k + n + n * res))))
        del x, r, kw
    return rows


def bench_tiles(g: torch.Generator) -> tuple[list[dict], list[str]]:
    """ms a launch of each nf 64 / gc 32 tile at each grid, and the rule's tile."""
    from esr_tpu_torch.ops.cuda import rdb_conv

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    params = kaiming_rdb_weights(64, 32, g)
    kw = rdb5c_kernel_weights(params, torch.bfloat16, torch.device("cuda"))
    tiles = [t for nf, gc, t in rdb_conv.INSTANCES if (nf, gc) == (64, 32)]
    rows, fields = [], []
    for shape in TILE_SHAPES:
        x = torch.randn(*shape, 64, device="cuda", generator=g).bfloat16()
        first = rdb_conv._launch(x, kw, tiles[0])
        plain_ms = launch_ms(lambda: rdb5c_reference(x, params), reps=3, windows=3)
        ms = []
        for t in tiles:  # each tile's time, and how far its answer is from the largest tile's
            off = (rdb_conv._launch(x, kw, t).float() - first.float()).abs().max().item()
            t_ms = graph_ms(lambda t=t: rdb_conv._launch(x, kw, t))
            rows.append(measured(f"rdb5c t{t}", "rdb5c", f"x {shape + (64,)}", t_ms, plain_ms, None,
                                 rdb_bound(*shape, 64, 32, 2)))
            ms.append(f"t{t} {t_ms:.4f}" + f" (off {off:.3g})" * bool(off))
        fields.append(f"rdb5c {'x'.join(map(str, shape))} {' '.join(ms)} rule t{rdb_conv.rdb5c_tile(64, 32, *shape, sms)}")
    return rows, fields


def kaiming_rdb_weights(nf: int, gc: int, g: torch.Generator) -> dict:
    """Kaiming-scale RDB weights, zero biases, on the card."""
    params = {}
    for k in range(1, 6):
        cin, cout = nf + gc * (k - 1), nf if k == 5 else gc
        params[f"w{k}"] = torch.randn(3, 3, cin, cout, device="cuda", generator=g) * (2.0 / (9 * cin)) ** 0.5
        params[f"b{k}"] = torch.zeros(cout, device="cuda")
    return params


def bench_widths(g: torch.Generator) -> tuple[list[dict], list[str]]:
    rows, fields = [], []
    for nf, gc in WIDTHS:
        x = torch.randn(16, 128, 128, nf, device="cuda", generator=g).bfloat16()
        params = kaiming_rdb_weights(nf, gc, g)
        kw = rdb5c_kernel_weights(params, torch.bfloat16, x.device)
        ms = launch_ms(lambda: rdb5c_launch(x, kw), reps=5, windows=3)
        rows.append(measured(f"rdb5c {nf}/{gc}", "rdb5c", f"x (16,128,128,{nf})", ms,
                             launch_ms(lambda: rdb5c_reference(x, params), reps=3, windows=3), None,
                             rdb_bound(16, 128, 128, nf, gc, 2)))
        fields.append(f"rdb5c nf {nf} gc {gc} {ms:.4f}")
        del x, kw
    return rows, fields


@torch.no_grad()
def table(mode: str = "") -> tuple[list[dict], list[str]]:
    """The rows and BENCH fields of a run: ``mode`` "" (bf16), "f32",
    "widths" or "tiles"; TF32 off, inputs and weights from seed 0."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    if mode == "widths":
        return bench_widths(g)
    if mode == "tiles":
        return bench_tiles(g)
    return bench_sites(g, mode == "f32")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--f32", action="store_true", help="time the f32 route instead of the bf16 kernels")
    what.add_argument("--widths", action="store_true", help="time the bf16 RDB at the widths of WIDTHS")
    what.add_argument("--tiles", action="store_true", help="time each nf 64 / gc 32 RDB tile at small grids")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_bench: needs an NVIDIA GPU")
    rows, fields = table("f32" * args.f32 or "widths" * args.widths or "tiles" * args.tiles)
    print(*map(text, rows), sep="\n", flush=True)
    print(f"BENCH {'f32 ' * args.f32}{torch.cuda.get_device_name(0)} | " + " | ".join(fields), flush=True)


if __name__ == "__main__":
    main()
