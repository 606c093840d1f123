"""The kernel libraries as built on the card, and the conv kernel at the
flagship forward's conv sites at the bench shape (B16; LR 128, HR 512).

The build: every library builds with nvcc (sm_90a) and its ptxas report
(``lib.build_all`` keeps it beside the library as ``.log``) shows no spill
in any instance of ``rdb5c_tc_kernel``, ``conv_tc_kernel``,
``conv_f32_kernel`` and ``layernorm_kernel``, and no serialized wgmma; the
main RDB instance's line is the one it had before the other widths became
instances. The sites: conv_first 4 -> 64 and trunk_conv 64 -> 64 at 128,
HRconv 64 -> 64 (LeakyReLU) and conv_last 64 -> 3 at 512, the upsample
convs 128 -> 256 and 256 -> 512, and a Cin of 256, on the f32 route within
F32_TOL of the f32 plain version and on the tensor cores within the bf16
conv band. The same sites' times are ``conv_bench``'s.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from esr_tpu_torch.models.blocks import upsample_nearest
from esr_tpu_torch.ops.cuda import kpack_conv, lib, rdb_conv
from esr_tpu_torch.ops.cuda.conv_bench import convT_weight
from esr_tpu_torch.ops.cuda.kpack_conv import conv3x3_reference, conv_kernel_weights, conv_launch, kpack_conv3x3
from esr_tpu_torch.ops.fused import upsample2x_conv3x3, upsample2x_conv3x3_reference
from torch_card import F32_TOL, card, conv_band, counts, cuda, gen, launched, max_err  # noqa: F401

# rdb5c_tc_kernel<64, 32, 16>'s ptxas report (the main path): the kernel's
# when nf 64 / gc 32 / tile 16 was its only shape, on the card's machine's
# nvcc; and the instance's part of its mangled name
RDB_PTXAS = ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", "Used 168 registers, used 2 barriers")
RDB_MAIN_MANGLED = "ILi64ELi32ELi16E"


@pytest.mark.cuda
def test_cuda_card_is_hopper(cuda):
    assert torch.cuda.get_device_capability(0) == (9, 0)


@pytest.fixture(scope="module")
def ptxas():
    """Each kernel library's ptxas report, built (if it is not) and loaded."""
    card()
    lib.build_all()
    out = {}
    for name in lib._SIGNATURES:
        lib.load(name)
        out[name] = lib._lib_path(name).with_suffix(".log").read_text().splitlines()
    return out


def _instances(report: list[str], kernel: str) -> list[int]:
    return [i for i, ln in enumerate(report) if "Function properties" in ln and kernel in ln]


@pytest.mark.cuda
def test_cuda_ptxas_rdb5c_instances_spill_nothing(ptxas):
    """Every rdb5c_tc_kernel instance: nothing in local memory, no wgmma
    serialized, and the main instance's line unchanged."""
    report = ptxas["rdb5c"]
    tc = {report[i].split("rdb5c_tc_kernel")[1][:20]: report[i + 1 : i + 3] for i in _instances(report, "rdb5c_tc_kernel")}
    spilled = {k: v[0].strip() for k, v in tc.items() if not v[0].strip().startswith(RDB_PTXAS[0])}
    serialized = [ln for ln in report if "are serialized" in ln and "rdb5c_tc_kernel" in ln]
    assert len(tc) == len(rdb_conv.INSTANCES) and not spilled and not serialized, (spilled, serialized)
    main = [v for k, v in tc.items() if k.startswith(RDB_MAIN_MANGLED)]
    assert main and tuple(ln.replace("ptxas info    :", "").strip() for ln in main[0]) == RDB_PTXAS


@pytest.mark.cuda
@pytest.mark.parametrize("library,kernel,instances,serial", [
    ("conv3x3", "conv_tc_kernel", 21, True), ("conv3x3", "conv_f32_kernel", 8, False),
    ("layernorm", "layernorm_kernel", 1, False), ("token_linear", "token_linear_kernel", 4, True),
    ("hat_attn", "hat_attn_kernel", 2, False), ("channel_attn", "ca_", 2, False)])
def test_cuda_ptxas_instances_spill_nothing(ptxas, library, kernel, instances, serial):
    """Every instance of the conv kernel's widths and modes (20, and the
    GELU epilogue's conv_tc_kernel_gelu), the f32 route's N 8 / 16 / 32 / 64
    in both modes (8), the LayerNorm kernel, the token-wise linear's four
    (K, NW, epilogue) instances, HAT's attention at key windows 16 and 24
    and its channel attention's pool and scale: nothing in local memory;
    the tensor-core kernels' wgmma pipelined."""
    report = ptxas[library]
    found = _instances(report, kernel)
    spilled = [report[i + 1].strip() for i in found if "0 bytes spill stores" not in report[i + 1]]
    serialized = [ln for ln in report if "are serialized" in ln and kernel in ln] if serial else []
    assert len(found) == instances and not spilled and not serialized, (spilled, serialized)


# (site, LR batch and edge, Cin, Cout, act, ksize): the flagship's conv sites at B16 x LR 128, and a Cin the
# earlier f32 kernel could not hold in shared memory
SITES = {"conv_first": (128, 4, 64, False, 3), "trunk_conv": (128, 64, 64, False, 3),
         "HRconv": (512, 64, 64, True, 3), "conv_last": (512, 64, 3, False, 3),
         "upconv1": (128, 64, 64, True, 2), "upconv2": (256, 64, 64, True, 2), "cin256": (128, 256, 64, True, 3)}


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SITES))
@torch.no_grad()
def test_cuda_conv_at_the_flagship_sites(cuda, site):
    """At B16: the f32 route (``conv_f32_kernel``) within F32_TOL of the f32
    plain version (nearest 2x + conv in 2x2 mode), one launch counted on its
    mode's f32 counter only; the library call conv_bench times for the 2x2
    mode (``F.conv_transpose2d`` of the folded 4x4 weight) computes the same;
    the tensor-core kernel, through the wrapper and with its layout built
    once, within the bf16 conv band of the f32 plain version on the same
    bf16 inputs."""
    s, cin, cout, act, ksize = SITES[site]
    i = list(SITES).index(site)
    x = gen((16, s, s, cin), 20 + i)
    w = gen((3, 3, cin, cout), 30 + i, math.sqrt(2.0 / (9 * cin)))
    bias = gen((cout,), 40 + i, 0.01)
    fn, plain = (kpack_conv3x3, conv3x3_reference) if ksize == 3 else (upsample2x_conv3x3, upsample2x_conv3x3_reference)
    ref = conv3x3_reference(x if ksize == 3 else upsample_nearest(x, 2), w, bias, act)
    before = counts()
    e = max_err(fn(x, w, bias, act), ref)
    assert launched(before, kpack_conv.LAUNCHES_F32_3X3 if ksize == 3 else kpack_conv.LAUNCHES_F32_2X2)
    assert e <= F32_TOL, e
    if ksize == 2:
        lib_out = F.conv_transpose2d(x.permute(0, 3, 1, 2), convT_weight(w), bias, stride=2, padding=1)
        assert max_err(F.leaky_relu(lib_out, 0.2).permute(0, 2, 3, 1), ref) <= F32_TOL
        del lib_out
    del ref
    if site == "cin256":  # the f32 route's width alone: the tensor cores take Cin up to 192
        return
    xb = x.bfloat16()
    del x
    ref_b = plain(xb.float(), w, bias, act)
    tol = conv_band(ref_b, max_err(plain(xb, w, bias, act), ref_b))
    kw = conv_kernel_weights(w, bias, torch.bfloat16, xb.device, ksize)
    assert max(max_err(fn(xb, w, bias, act), ref_b), max_err(conv_launch(xb, kw, act), ref_b)) <= tol
