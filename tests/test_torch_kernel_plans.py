"""The launch plans of K1 forward (``convlstm_fused.gate_update_plan``) and
K7 (``chained_gather.plan``): pure Python, held here without a card. Each
kernel's index mapping is replayed in numpy from its plan, so these tests
show that a launch covers its work exactly once; the card checks the
kernels against their plain versions (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from chip_smoke import k1_levels
from unet_convlstm_tpu_torch.ops.kernels import build
from unet_convlstm_tpu_torch.ops.kernels import chained_gather as cg
from unet_convlstm_tpu_torch.ops.kernels import convlstm_fused as cf
from unet_convlstm_tpu_torch.ops.kernels import reset_launches
from unet_convlstm_tpu_torch.probes import kernel_ab, probe_gather

# (batch, map side, base_ch) of the paths that run K1: serving at B=4, T=4
# and B=1 (128x128, base_ch 64), the training step (B=64, T=10), the
# training run (configs/mnist_small.json: B=32) and its one served request,
# and the overfit gate (4 sequences, base_ch 16), all 64x64
PATHS = {"serve_b4": (4, 128, 64), "serve_b1": (1, 128, 64),
         "train_b64": (64, 64, 32), "fit_b32": (32, 64, 32),
         "fit_serve_b1": (1, 64, 32), "overfit_b4": (4, 64, 16)}
K1_CASES = [(path, batch * side * side, C)
            for path, (batch, hw, base) in PATHS.items()
            for _, C, side, _ in k1_levels(base, hw, 1)]
DTYPES = (torch.bfloat16, torch.float32)


def _k1_vectors(p: cf.Plan, nvec: int) -> np.ndarray:
    """The vectors the vector kernel's threads visit: thread t of block b
    takes v = b * THREADS + t, then strides by the grid."""
    first = np.arange(p.blocks * cf.THREADS)
    step = p.blocks * cf.THREADS
    return np.concatenate([first[first + k * step < nvec] + k * step
                           for k in range(-(-nvec // step))])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path,rows,C", K1_CASES)
def test_every_path_gate_update_takes_the_vector_route(path, rows, C, dtype):
    p = cf.gate_update_plan(rows, C, dtype, True)
    assert p.route == "vector"
    assert p.vec == (8 if dtype == torch.bfloat16 else 4)
    assert p.vec * torch.finfo(dtype).bits // 8 == 16      # 16-byte vectors
    nvec = rows * C // p.vec
    assert p.blocks == min(-(-nvec // cf.THREADS), cf.SMS * cf.BLOCKS_PER_SM)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,C,aligned", [
    (1000, 10, True),     # C not a multiple of the vector, in bf16 and f32
    (64, 6, True),
    (1024, 64, False),    # a base address off a 16-byte boundary
    (3, 1024, False)])
def test_scalar_route_where_the_vector_route_does_not_go(rows, C, aligned,
                                                          dtype):
    p = cf.gate_update_plan(rows, C, dtype, aligned)
    assert p.route == "scalar" and p.vec == 1
    assert p.blocks == min(-(-rows * C // cf.THREADS),
                           cf.SMS * cf.SCALAR_BLOCKS_PER_SM)


def test_vector_route_of_f32_takes_four_channel_vectors():
    for C in (4, 12):      # chip_smoke.py's C = 12 case is bf16: scalar
        assert cf.gate_update_plan(10, C, torch.float32, True).route \
            == "vector"
        assert cf.gate_update_plan(10, C, torch.bfloat16, True).route \
            == "scalar"


@pytest.mark.parametrize("rows,C,dtype", [
    (256, 1024, torch.bfloat16),      # serving's bottleneck: a part wave
    (16384, 128, torch.bfloat16),     # training's skip2: the grid strides
    (4096, 256, torch.float32),
    (1000, 12, torch.bfloat16),       # the scalar route
    (777, 8, torch.float32),
    (1, 8, torch.bfloat16)])
def test_gate_update_grid_covers_rows_by_c_exactly_once(rows, C, dtype):
    p = cf.gate_update_plan(rows, C, dtype, True)
    if p.route == "scalar":
        seen = _k1_vectors(p, rows * C)        # one element a thread
        assert np.array_equal(np.sort(seen), np.arange(rows * C))
        return
    nvec = rows * C // p.vec
    v = _k1_vectors(p, nvec)
    assert np.array_equal(np.sort(v), np.arange(nvec))
    # the elements each vector covers, in c/h/c' and in the gates
    groups = C // p.vec
    r = v // groups
    lanes = np.arange(p.vec)
    out = (v[:, None] * p.vec + lanes).ravel()
    assert np.array_equal(np.sort(out), np.arange(rows * C))
    gate = np.concatenate([(v[:, None] * p.vec + r[:, None] * 3 * C
                            + q * C + lanes).ravel() for q in range(4)])
    assert np.array_equal(np.sort(gate), np.arange(rows * 4 * C))
    j = (out % C).reshape(-1, p.vec)
    assert np.array_equal(j[:, 0] // p.vec, v % groups)   # C's vector j


def test_route_counts_reset_and_the_cpu_counts_none():
    cf.launches_by_route["vector"] = 3
    reset_launches()
    assert cf.launches_by_route == {"vector": 0, "scalar": 0}
    cf.fused_gate_update(torch.zeros(4, 32, dtype=torch.bfloat16),
                         torch.zeros(4, 8))     # the plain version
    assert cf.launches == 0
    assert cf.launches_by_route == {"vector": 0, "scalar": 0}


def test_gate_update_plan_depends_on_the_shape_alone():
    rng = np.random.default_rng(0)
    plans = set()
    for _ in range(3):
        gates = torch.from_numpy(rng.standard_normal((512, 4 * 64))
                                 .astype(np.float32)).to(torch.bfloat16)
        c = torch.from_numpy(rng.standard_normal((512, 64)).astype(
            np.float32))
        plans.add(cf.plan_for(gates, c))
    assert plans == {cf.gate_update_plan(512, 64, torch.bfloat16, True)}
    # a view one element into a bf16 buffer is off a 16-byte boundary
    buf = torch.zeros(512 * 4 * 64 + 1, dtype=torch.bfloat16)
    view = buf[1:].view(512, 4 * 64)
    assert cf.plan_for(view, torch.zeros(512, 64)).route == "scalar"
    assert cf.gate_update_plan(0, 64, torch.bfloat16, True).blocks == 0


# K7: the gather probe's five shapes, the longest lines it takes, and
# shapes whose last tile holds fewer lines than the others ((17, 128) axis 1
# and (512, 20) axis 0 leave most blocks of that tile without a chain)
LONGEST = cg._SMEM_BYTES // 4 - 1
K7_CASES = ([(shape, axis) for _, shape, axis in probe_gather.VARIANTS]
            + [((4, LONGEST), 1), ((LONGEST, 16), 0), ((7, 5), 0),
               ((20, 14000), 1), ((29056, 3), 0), ((40, 33), 1),
               ((17, 128), 1), ((512, 20), 0), ((5000, 40), 0)])


def _k7_cover(R: int, L: int, axis: int, p: cg.Plan) -> np.ndarray:
    """How often each element's chain runs, replaying the kernel's blocks:
    block (tile, split) has chains e in [split * chunk, + chunk) of its
    tile, e = position * here + line, and returns at once where it has
    none. Every global offset a running block reads (its threads' first
    start indices, loaded before staging, and the tile it stages) must lie
    inside x."""
    n, nlines = (R, L) if axis == 0 else (L, R)
    runs = np.zeros((nlines, n), np.int64)

    def goff(line, pos):
        return line * L + pos if axis == 1 else pos * L + line

    for b in range(p.blocks):
        tile, split = divmod(b, p.splits)
        line0 = tile * p.lines
        here = min(p.lines, nlines - line0)
        c0, c1 = split * p.chunk, min((split + 1) * p.chunk, here * n)
        if c0 >= here * n:
            continue
        e = np.arange(c0, c1)
        np.add.at(runs, (line0 + e % here, e // here), 1)
        mine = c0 + np.arange(p.threads)
        first = np.where(mine < c1, mine, c0)
        staged = np.arange(here * n)
        for chains in (first, staged):
            off = goff(line0 + chains % here, chains // here)
            assert off.min() >= 0 and off.max() < R * L
    return runs


@pytest.mark.parametrize("shape,axis", K7_CASES)
@pytest.mark.parametrize("pair", [None, False])
def test_chained_gather_plan_covers_every_line_once(shape, axis, pair):
    p = cg.plan(*shape, axis, pair)
    assert np.all(_k7_cover(*shape, axis, p) == 1)
    n, nlines = (shape[0], shape[1]) if axis == 0 else shape[::-1]
    assert p.blocks == -(-nlines // p.lines) * p.splits
    assert p.lines & (p.lines - 1) == 0           # the kernel's slot shift
    assert p.smem_bytes == p.lines * n * (8 if p.pair else 4)
    assert p.smem_bytes <= 227 * 1024
    assert p.pair == (pair if pair is not None
                      else 8 * n <= cg._SMEM_BYTES)
    assert 32 <= p.threads <= cg.MAX_THREADS and p.threads % 32 == 0
    # every block on an SM at once: threads, registers and shared memory
    per_sm = min(2048 // p.threads, 65536 // (p.threads * cg.REGS),
                 (228 * 1024) // (p.smem_bytes + 1024))
    assert p.blocks <= cg.SMS * per_sm


@pytest.mark.parametrize("shape,axis", [(s, a) for _, s, a in
                                        probe_gather.VARIANTS])
def test_probe_shapes_keep_x_beside_next(shape, axis):
    p = cg.plan(*shape, axis)
    assert p.pair and p.chunk <= p.threads       # one chain a thread
    nlines = shape[1] if axis == 0 else shape[0]
    assert p.lines == (cg.TILE if nlines >= cg.TILE else 1)
    # the 4-byte layout tiles the same lines
    assert cg.plan(*shape, axis, False).lines == p.lines


@pytest.mark.parametrize("axis", [0, 1])
def test_chained_gather_plan_takes_exactly_the_lines_of_before(axis):
    """The wrapper took a line of n values where 4 (n + 1) bytes fit in a
    block's 227 KB; the plan takes the same and raises beyond."""
    for n in (1, 128, 29056, 29057, LONGEST):
        shape = (n, 3) if axis == 0 else (3, n)
        assert 4 * (n + 1) <= cg._SMEM_BYTES
        assert cg.plan(*shape, axis).pair == (8 * n <= cg._SMEM_BYTES)
    shape = (LONGEST + 1, 3) if axis == 0 else (3, LONGEST + 1)
    with pytest.raises(ValueError, match="does not fit"):
        cg.plan(*shape, axis)
    shape = (29057, 3) if axis == 0 else (3, 29057)
    with pytest.raises(ValueError, match="beside its next"):
        cg.plan(*shape, axis, True)


# the card's A/B of the designs (probes.kernel_ab)
def test_kernel_ab_times_k1_at_the_paths_levels():
    want = [(per, level, batch * side * side, C, n)
            for per, (batch, hw, base, t) in (("request", (4, 128, 64, 4)),
                                              ("step", (64, 64, 32, 10)))
            for level, C, side, n in k1_levels(base, hw, t)]
    assert list(kernel_ab.K1_LEVELS) == want


@pytest.mark.parametrize("name,edits", [
    ("gate_update", kernel_ab.K1_PRECISE),
    ("chained_gather", kernel_ab.K7_NO_UNROLL),
    ("conv_int8", [(kernel_ab.K8_ANCHOR,
                    kernel_ab.K8_QUANTIZE_PASS + kernel_ab.K8_ANCHOR)])])
def test_design_variants_edit_the_shipped_source_once(name, edits):
    text = build.sources()[name].read_text()
    for old, new in edits:
        assert text.count(old) == 1 and old != new
    with pytest.raises(ValueError, match="not once"):
        build.load_variant(name, [("no such text in a kernel", "")])


def test_kernel_ab_reads_ptxas_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kPf\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n")
    assert kernel_ab.ptxas(log) == {"_Z1kPf": {"spill_bytes": 4,
                                               "registers": 64}}
