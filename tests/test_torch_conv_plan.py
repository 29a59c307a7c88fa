"""The fused conv's planner (``doubleconv_fused.plan``): which route and
tiling every conv of the serving and training paths gets, from the shape
alone. It is pure Python, so it is held here without a card; the card
checks each planned shape against the plain version (``chip_smoke.py``,
whose ``k2_convs`` lists a pass's convs: level i has base * 2^i channels
on hw / 2^i maps, inc conv1 with its 2 input channels is a library conv).
"""

import pytest
import torch

from chip_smoke import k2_convs
from unet_convlstm_tpu_torch.ops.kernels import doubleconv_fused as dc


# (images a pass, map side): serving at B=4, T=4 and at B=1, T=1 (128x128),
# the training step at B=64, T=10 (64x64)
GEOMETRIES = {"serve_b4t4": (16, 128), "serve_b1t1": (1, 128),
              "train_b64t10": (640, 64)}
CASES = [(geo, base, side, cin, cout)
         for geo, (n, hw) in GEOMETRIES.items() for base in (16, 32, 64)
         for side, cin, cout, _, _ in k2_convs(base, hw)]


@pytest.mark.parametrize("geo,base,side,cin,cout", CASES)
def test_every_path_conv_takes_the_wgmma_route(geo, base, side, cin, cout):
    n = GEOMETRIES[geo][0]
    p = dc.plan(n, side, side, cin, cout, torch.bfloat16)
    assert p.route == "wgmma"
    assert cout % p.bn == 0 and p.bn in (16, 32, 64, 128)
    assert cin % p.bk == 0 and p.bk in (16, 32, 64)
    assert (p.bn, p.bk) in dc._WGMMA_TILES
    m = n * side * side
    tiles = -(-m // p.bm) * (cout // p.bn)
    assert p.blocks == tiles * p.splits
    chunks = 9 * cin // p.bk
    assert 1 <= p.splits <= chunks
    # enough work units for the SMs, unless the split is at its limit
    split_limit = (p.splits >= chunks // dc.MIN_CHUNKS_PER_SPLIT
                   or (p.splits + 1) * m * cout * 4 > dc.WORKSPACE_CAP)
    assert p.blocks >= dc.SMS or split_limit
    assert p.workspace_bytes <= dc.WORKSPACE_CAP
    assert p.workspace_bytes == (4 * p.splits * m * cout if p.splits > 1
                                 else 0)
    assert p.splits == 1 or tiles < dc.SMS   # split only a short grid
    assert p.stages == (3 if p.bk == 64 else 4)


@pytest.mark.parametrize("cin,cout,dtype", [
    (64, 64, torch.float32),       # the FP32 policy
    (1024, 1024, torch.float32),
    (8, 64, torch.bfloat16),       # Cin a multiple of 8, not of 16
    (24, 32, torch.bfloat16),
    (64, 24, torch.bfloat16),      # Cout 24, 40, 96: no tile divides them
    (64, 40, torch.bfloat16),
    (128, 96, torch.bfloat16),
])
def test_generic_route_takes_f32_and_what_wgmma_does_not(cin, cout, dtype):
    assert dc.kernel_supports(cin, cout, dtype)
    p = dc.plan(16, 16, 16, cin, cout, dtype)
    assert p.route == "generic" and p.splits == 1
    assert p.workspace_bytes == 0
    assert p.blocks == -(-16 * 16 * 16 // 128) * -(-cout // 64)


def test_plan_depends_on_the_shape_alone():
    shape = (16, 8, 8, 1024, 1024, torch.bfloat16)
    assert dc.plan(*shape) == dc.plan(*shape)
    p = dc.plan(*shape)
    # 8 pixel tiles x 8 channel tiles = 64 < 132 SMs: K is split, to about
    # two blocks per SM
    assert (p.bn, p.bk, p.splits, p.blocks) == (128, 64, 4, 256)
    # 20,480 pixel tiles of 32 channels: one block each, no split
    t = dc.plan(640, 64, 64, 32, 32, torch.bfloat16)
    assert (t.bn, t.bk, t.splits, t.blocks) == (32, 32, 1, 20480)
    # a ragged pixel count (300) and a split capped by the K chunks
    r = dc.plan(3, 10, 10, 64, 64, torch.bfloat16)
    assert r.route == "wgmma" and r.splits == 9 // dc.MIN_CHUNKS_PER_SPLIT


def test_plan_of_an_empty_batch_launches_no_main_kernel():
    # no pixel tile: no split, no workspace, no block; the launch then runs
    # only the prep kernel, which zeroes the sums
    p = dc.plan(0, 8, 8, 512, 512, torch.bfloat16)
    assert (p.route, p.splits, p.blocks, p.workspace_bytes) == (
        "wgmma", 1, 0, 0)


@pytest.mark.parametrize("cin,cout,dtype", [(2, 64, torch.bfloat16),
                                            (64, 12, torch.bfloat16),
                                            (64, 64, torch.float16)])
def test_plan_rejects_what_no_route_takes(cin, cout, dtype):
    with pytest.raises(ValueError, match="multiples of 8"):
        dc.plan(1, 8, 8, cin, cout, dtype)
