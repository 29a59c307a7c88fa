"""The yardstick's arithmetic pinned against numbers worked out by hand:
K1's and K2's bytes and operations a launch, the launches a step and a
request make, and the model FLOPs behind mfu on two small shapes."""

import pytest

from port_bench import roofline as r

CUSTOM = {"type": "custom", "base_ch": 4, "lstm_layers": 1,
          "use_skip_lstm": True, "in_channels_per_sat": 1, "out_channels": 1}


def test_k2_operations_and_bytes():
    # m = 2*4*4 = 32 pixels, 16 -> 32 channels
    with_pro = r.k2(2, 4, 4, 16, 32, prologue=True)
    assert with_pro.ops == 2 * 32 * 9 * 16 * 32 == 294912
    # bf16 x 32*16, w 9*16*32, y 32*32; f32 bias 32, inv+shift 2*16, sums 2*32
    assert with_pro.nbytes == 2 * (512 + 4608 + 1024) + 4 * (32 + 32 + 64)
    assert with_pro.nbytes == 12800
    assert r.k2(2, 4, 4, 16, 32, prologue=False).nbytes == 12672
    # bound by bytes: 12800 / 3.35e12 > 294912 / 989e12
    assert with_pro.bound_s == pytest.approx(12800 / 3.35e12)


def test_k1_bytes():
    assert r.k1_fwd(10, 8).nbytes == 10 * 8 * 18 == 1440
    assert r.k1_bwd(10, 8).nbytes == 10 * 8 * 30 == 2400
    assert r.k1_bwd(10, 8, dc_in=False).nbytes == 2080
    assert r.k1_fwd(10, 8).ops == 0


def test_launches_a_step_and_a_request():
    big = dict(CUSTOM, base_ch=64)
    assert r.launch_counts(big, 32, 12, 128, 128, train=True) == {
        "gate_update": 36, "gate_update_bwd": 36, "conv3x3_fused": 17}
    assert r.launch_counts(big, 64, 1, 128, 128, train=False) == {
        "gate_update": 3, "gate_update_bwd": 0, "conv3x3_fused": 17}
    step = r.launches(big, 32, 12, 128, 128, train=True)
    assert sum(l.kernel == "k2" for l in step) == 17
    assert sum(l.kernel == "k1" for l in step) == 72


def test_custom_forward_flops_by_hand():
    # 16x16, base_ch 4: five encoder levels of 55,296 MACs, three gate
    # convs of 294,912, four up blocks of 118,784 and the 1x1 head 1,024
    macs = 5 * 55296 + 3 * 294912 + 4 * 118784 + 1024
    assert macs == 1637376
    assert r.model_flops(CUSTOM, 1, 1, 16, 16, train=False) == 2 * macs


def test_custom_train_flops_by_hand():
    # T=2: the forward twice; weight gradients everywhere but the h halves
    # of the gate convs at the first step (3 x 147,456); input gradients
    # everywhere but the network input (2 x 18,432) and those h halves
    fwd = 2 * 1637376
    dw = fwd - 3 * 147456
    dx = fwd - 2 * 18432 - 3 * 147456
    assert r.model_flops(CUSTOM, 1, 2, 16, 16, train=True) == \
        2 * (fwd + dw + dx) == 17805312
