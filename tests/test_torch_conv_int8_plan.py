"""K8's planner (``conv_int8.plan``): which route, tile, stages and split
every int8 conv of the two int8 paths gets, from the shape alone. It is
pure Python, so it is held here without a card; the card checks each
planned shape against the plain version (``chip_smoke.py``, whose
``k8_custom_convs`` and ``k8_resnet_convs`` list a pass's convs and
``K8_RAGGED`` the shapes off the paths).
"""

import pytest
import torch

from chip_smoke import (B, BASE, HW, K8_CUSTOM, K8_RAGGED, K8_RESNET, T,
                        k8_custom_convs, k8_plan, k8_route_counts)
from unet_convlstm_tpu_torch.ops.kernels import conv_int8 as k8
from unet_convlstm_tpu_torch.ops.kernels import reset_launches

X_DTYPES = (torch.bfloat16, torch.float32, torch.int8)
PATH_CASES = [(path, c) for path, convs in (("custom", K8_CUSTOM),
                                             ("resnet", K8_RESNET))
              for c in convs]


def _gemm(kind, n, h, w, cin, cout, k, stride, pad):
    """(M, columns, depth) of one conv."""
    if kind == "up2":
        return n * h * w, 4 * cout, cin
    side = lambda s: k8.out_size(s, k, stride, (pad, pad))   # noqa: E731
    return n * side(h) * side(w), cout, k * k * cin


def _smem(p, esize):
    """The wgmma route's ring bytes (Cfg::PIPE_BYTES)."""
    s8 = 2 * p.bm * p.bk if esize > 1 else 0
    return p.stages * (p.bm * p.bk * esize + p.bn * p.bk) + s8


@pytest.mark.parametrize("x_dtype", X_DTYPES)
@pytest.mark.parametrize("path,conv", PATH_CASES,
                         ids=[f"{p}-{c[0]}-{c[1]}x{c[2]}-{c[4]}to{c[5]}"
                              f"-k{c[6]}s{c[7]}" for p, c in PATH_CASES])
def test_every_path_conv_gets_its_route_and_tile(path, conv, x_dtype):
    kind, n, h, w, cin, cout, k, stride, pad, _ = conv
    p = k8_plan(kind, n, h, w, cin, cout, k, stride, pad, x_dtype)
    m, cols, depth = _gemm(kind, n, h, w, cin, cout, k, stride, pad)
    esize = x_dtype.itemsize
    if cin % 16:                      # the 2-channel input and the stem
        assert p.route == "gather" and p.bk == 32
    elif cout == 1:                   # outc and the resnet head
        assert p.route == "vec"
    else:
        assert p.route == "wgmma"
    if p.route != "wgmma":
        assert (p.bm, p.bn, p.splits, p.workspace_bytes) == (128, 64, 1, 0)
        assert p.blocks == -(-m // 128) * -(-cols // 64)
        return
    assert cin % 16 == 0 and cout % 8 == 0 and depth >= 32
    assert p.bk * esize <= 128 and p.bk in (32, 64, 128)
    # the halo mode: every 3x3 stride-1 conv of a float x with Cin % 32 == 0
    # on the paths (their maps are at most 128 wide); BK divides Cin
    assert p.halo == (esize > 1 and (k, stride, pad) == (3, 1, 1)
                      and cin % 32 == 0)
    if p.halo:
        assert cin % p.bk == 0
        assert k8._halo_bytes(p.bm, p.bn, p.bk, esize, w) <= k8.HALO_BUDGET
        assert p.bk == 32 or p.bk * esize <= 128
    else:
        # BK: the widest of 128/64/32 channels staging at most 128 bytes a
        # row that divides K
        assert depth % p.bk == 0 or p.bk == 32
        assert all(depth % b or b * esize > 128
                   for b in (128, 64) if b > p.bk)
    if esize > 1 and cols >= 256:     # the wide tile of a float x
        assert (p.bm, p.bn) == (64, 256)
    else:
        assert p.bm == 128
        assert p.bn == (128 if cols >= 128 else 64 if cols >= 64 else 32)
    # the ring fits two blocks an SM, 2 to 4 stages (the halo mode's weight
    # ring: 4, or 3 for the wide tile)
    if p.halo:
        assert p.stages == (3 if p.bn == 256 else 4)
    else:
        assert 2 <= p.stages <= 4
        assert _smem(p, esize) <= k8.PIPE_BUDGET or p.stages == 2
        assert p.stages == 4 or _smem(
            p.__class__(**{**p.__dict__, "stages": p.stages + 1}),
            esize) > k8.PIPE_BUDGET
    tiles = -(-m // p.bm) * -(-cols // p.bn)
    assert p.blocks == tiles * p.splits
    # split units: K chunks (at least MIN_CHUNKS_PER_SPLIT a split), or in
    # the halo mode channel blocks of 9 chunks each
    units = (cin // p.bk if p.halo
             else -(-depth // p.bk) // k8.MIN_CHUNKS_PER_SPLIT)
    assert 1 <= p.splits <= max(1, units)
    assert p.splits == 1 or tiles < k8.SMS       # split only a short grid
    split_limit = (p.splits >= units
                   or p.splits >= 2 * k8.SMS // tiles
                   or (p.splits + 1) * m * cols * 4 > k8.WORKSPACE_CAP)
    assert tiles >= k8.SMS or split_limit
    assert p.workspace_bytes == (4 * p.splits * m * cols if p.splits > 1
                                 else 0)
    assert p.workspace_bytes <= k8.WORKSPACE_CAP


@pytest.mark.parametrize("x_dtype", X_DTYPES)
@pytest.mark.parametrize("convs,expect", [
    (K8_CUSTOM, {"wgmma": 57, "vec": 1, "gather": 1}),     # int8 forward
    (k8_custom_convs(BASE, HW, B, T), {"wgmma": 33, "vec": 1,
                                       "gather": 1}),    # a request
    (K8_RESNET, {"wgmma": 69, "vec": 1, "gather": 1})],  # resnet request
    ids=["custom_forward", "custom_request", "resnet_request"])
def test_launches_by_route_of_each_path(convs, expect, x_dtype):
    assert k8_route_counts(convs, x_dtype) == expect


@pytest.mark.parametrize("conv,x_dtype,expect", [
    # the custom gate conv at the bottleneck: 8 x 16 wide tiles of a bf16
    # x (an int8 x: 4 x 32), split in two
    (("conv", 8, 8, 8, 2048, 4096, 3, 1, 1), torch.bfloat16,
     ("wgmma", 64, 256, 64, 3, 2, 256)),
    (("conv", 8, 8, 8, 2048, 4096, 3, 1, 1), torch.int8,
     ("wgmma", 128, 128, 128, 3, 2, 256)),
    # the resnet bottleneck gate conv: 64 pixels, one pixel tile of 8
    # column tiles, split over its 16 channel blocks (the halo mode)
    (("conv", 4, 4, 4, 1024, 2048, 3, 1, 1), torch.bfloat16,
     ("wgmma", 64, 256, 64, 3, 16, 128)),
    # the wide shallow map: 64 columns, 4 stages, no split
    (("conv", 96, 128, 128, 64, 64, 3, 1, 1), torch.bfloat16,
     ("wgmma", 128, 64, 64, 4, 1, 12288)),
    (("conv", 96, 128, 128, 64, 64, 3, 1, 1), torch.float32,
     ("wgmma", 128, 64, 32, 4, 1, 12288)),
    # a transposed conv: 4 * 64 columns over 393,216 input pixels
    (("up2", 96, 64, 64, 128, 64, 2, 2, 0), torch.bfloat16,
     ("wgmma", 64, 256, 64, 3, 1, 6144)),
    (("up2", 96, 64, 64, 128, 64, 2, 2, 0), torch.int8,
     ("wgmma", 128, 128, 128, 3, 1, 6144)),
    # Cin 16: K 144 in chunks of 32 (the last half zero), 16 columns
    (("conv", 16, 128, 128, 16, 16, 3, 1, 1), torch.bfloat16,
     ("wgmma", 128, 32, 32, 4, 1, 2048))])
def test_plans_of_named_shapes(conv, x_dtype, expect):
    p = k8_plan(*conv, x_dtype=x_dtype)
    assert (p.route, p.bm, p.bn, p.bk, p.stages, p.splits,
            p.blocks) == expect
    assert p == k8_plan(*conv, x_dtype=x_dtype)        # the shape alone


RAGGED_ROUTES = ["gather", "gather", "wgmma", "wgmma", "gather", "gather",
                 "wgmma", "wgmma", "wgmma", "wgmma", "wgmma", "vec", "vec",
                 "wgmma", "wgmma"]


@pytest.mark.parametrize("conv,route", list(zip(K8_RAGGED, RAGGED_ROUTES)),
                         ids=[f"{c[0]}-{c[4]}to{c[5]}-k{c[6]}s{c[7]}-{r}"
                              for c, r in zip(K8_RAGGED, RAGGED_ROUTES)])
def test_ragged_shapes_cover_every_route_and_edge(conv, route):
    p = k8_plan(*conv[:-1])
    assert p.route == route
    m, cols, depth = _gemm(*conv[:-1])
    if route == "wgmma":
        assert m % 128 or cols % p.bn or depth % p.bk or p.splits > 1 \
            or depth == 32


def test_ragged_shapes_reach_split_k_and_ragged_tiles():
    plans = [(c, k8_plan(*c[:-1])) for c in K8_RAGGED]
    wg = [(c, p) for c, p in plans if p.route == "wgmma"]
    assert sum(p.splits > 1 for _, p in wg) >= 2
    assert any(_gemm(*c[:-1])[1] % p.bn for c, p in wg)       # columns
    assert any(_gemm(*c[:-1])[0] % 128 for c, p in wg)        # pixels
    assert any(_gemm(*c[:-1])[2] % p.bk for c, p in wg)       # K chunk
    assert {c[4] for c, _ in wg} >= {16, 48}
    assert {p.bk for c, p in plans if p.route == "vec"} == {32, 64}
    # the halo mode of a bf16 x: maps whose tiles straddle images, and split
    halo = [(c, k8_plan(*c[:-1])) for c in K8_RAGGED]
    halo = [(c, p) for c, p in halo if p.halo]
    assert any(c[1] > 1 and (c[1] * c[2] * c[3]) % p.bm for c, p in halo)
    assert any(p.splits > 1 for _, p in halo)
    assert any(p.bm == 64 for _, p in halo) and any(p.bm == 128
                                                    for _, p in halo)


@pytest.mark.parametrize("x_dtype", X_DTYPES)
def test_an_offset_view_takes_the_byte_gather(x_dtype):
    shape = (2, 9, 7, 32)
    n = 2 * 9 * 7 * 32
    x = torch.zeros(n + 1, dtype=x_dtype)[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    w_gemm = torch.zeros(24, 288, dtype=torch.int8)
    p = k8.conv_plan(shape, (24, 32, 3, 3), 1, ((1, 1), (1, 1)), x_dtype)
    assert p.route == "wgmma"
    m = 2 * 9 * 7
    q = k8.route_plan(x, w_gemm, p, m, 24)
    assert (q.route, q.splits, q.bk, q.blocks) == ("gather", 1, 32, 1)
    aligned = torch.zeros(n, dtype=x_dtype).view(shape)
    assert k8.route_plan(aligned, w_gemm, p, m, 24) == p


def test_plan_refuses_other_x_dtypes():
    with pytest.raises(TypeError, match="int8, bf16 or f32"):
        k8.plan(128, 64, 64, 64, 576, torch.float16)


def test_reset_launches_clears_the_route_and_entry_counts():
    k8.launches_by_route["wgmma"] = 3
    k8.launches_by_entry["quant"] = 2
    reset_launches()
    assert k8.launches_by_route == {"wgmma": 0, "vec": 0, "gather": 0}
    assert k8.launches_by_entry == {"int8": 0, "quant": 0}
