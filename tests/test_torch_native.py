"""The port's native host kernels (native/hostio.cpp, built with g++ here
as on the card's machine) against the JAX package's own native route and
the numpy versions: the fused gather and transpose, the Moving-MNIST paste,
and the build (a hash directory per source, a failed build raises).

Tolerance: none. Both kernels copy floats and add small integers (vx in
[-5, 5]), so every comparison is bit for bit."""

import os
import shutil

import numpy as np
import pytest

from unet_convlstm_tpu.data import fast_gather as jfg
from unet_convlstm_tpu.data import moving_mnist as jmm
from unet_convlstm_tpu.native.build import load_hostio as jax_hostio
from unet_convlstm_tpu_torch.data import fast_gather as tfg
from unet_convlstm_tpu_torch.data import moving_mnist as tmm
from unet_convlstm_tpu_torch.native import build as tbuild


@pytest.fixture(scope="module")
def jlib():
    lib = jax_hostio()
    assert lib is not None, "the JAX package's hostio did not build"
    return lib


def _src(c, n=7, t=3, h=9, w=13, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, t, c, h, w)).astype(np.float32)


@pytest.mark.parametrize("nthreads", [1, 3])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_gather_transpose_matches_jax_native(jlib, channels, nthreads):
    src = _src(channels)
    idx = np.array([4, 0, 6, 4, 2], np.int64)
    before = dict(tfg.calls_by_route)
    got = tfg.gather_transpose(src, idx, nthreads=nthreads)
    assert tfg.calls_by_route["native"] == before["native"] + 1
    want = jfg.gather_transpose(src, idx, nthreads=nthreads)
    assert got.shape == (5, 3, 9, 13, channels) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tfg.gather_transpose_plain(src, idx))


def test_plain_route_on_noncontiguous_and_other_dtypes():
    src = _src(2, h=12)
    idx = np.array([1, 2], np.int64)
    for arr in (src[:, :, :, ::2, :], src.astype(np.float64)):
        before = dict(tfg.calls_by_route)
        got = tfg.gather_transpose(arr, idx)
        assert tfg.calls_by_route["numpy"] == before["numpy"] + 1
        assert tfg.calls_by_route["native"] == before["native"]
        np.testing.assert_array_equal(got, jfg.gather_transpose(arr, idx))


def test_gather_fills_out_and_checks_it_before_writing():
    src = _src(3)
    idx = np.array([5, 1], np.int64)
    out = np.empty((2, 3, 9, 13, 3), np.float32)
    assert tfg.gather_transpose(src, idx, out=out) is out
    np.testing.assert_array_equal(out, jfg.gather_transpose(src, idx))
    for bad in (np.full((2, 3, 9, 13, 2), 7, np.float32),
                np.full((2, 3, 9, 13, 3), 7, np.float64),
                np.full((2, 3, 9, 3, 13), 7, np.float32).transpose(
                    0, 1, 2, 4, 3)):
        with pytest.raises(ValueError, match="C-contiguous float32"):
            tfg.gather_transpose(src, idx, out=bad)
        assert (bad == 7).all()          # nothing was written


@pytest.mark.parametrize("idx", [[7], [-1], [0, 7]])
def test_gather_index_out_of_range_raises(idx):
    with pytest.raises(IndexError, match="out of range"):
        tfg.gather_transpose(_src(2), np.array(idx))
    with pytest.raises(IndexError, match="out of range"):
        jfg.gather_transpose(_src(2), np.array(idx))


def test_gather_of_no_indices():
    got = tfg.gather_transpose(_src(2), np.array([], np.int64))
    assert got.shape == (0, 3, 9, 13, 2)


def test_paste_digit_matches_jax_and_numpy(jlib):
    rng = np.random.default_rng(3)
    S = 40
    frames = [np.zeros((S, S), np.float32) for _ in range(3)]
    vels = [np.zeros((S, S), np.float32) for _ in range(3)]
    for k in range(4):   # overlapping windows: later digits overwrite
        digit = rng.random((28, 28)).astype(np.float32)
        digit[digit < 0.5] = 0.0
        y, x = (int(v) for v in rng.integers(0, S - 27, 2))
        vx = float(rng.integers(-5, 6))
        tmm.paste_digit(frames[0], vels[0], digit, y, x, vx)
        jlib.paste_digit_f32(frames[1].ctypes.data, vels[1].ctypes.data,
                             digit.ctypes.data, S, y, x, vx)
        tmm.paste_digit_plain(frames[2], vels[2], digit, y, x, vx)
    for a in frames[1:]:
        np.testing.assert_array_equal(frames[0], a)
    for a in vels[1:]:
        np.testing.assert_array_equal(vels[0], a)
    assert (frames[0] > 0).any() and (vels[0] != 0).any()


def test_paste_digit_checks_its_buffers():
    frame = np.zeros((32, 32), np.float32)
    digit = np.ones((28, 28), np.float32)
    with pytest.raises(ValueError, match="outside"):
        tmm.paste_digit(frame, frame.copy(), digit, 5, 0, 1.0)
    with pytest.raises(ValueError, match="float32"):
        tmm.paste_digit(frame, frame.copy(), digit.astype(np.float64), 0, 0,
                        1.0)


def test_generate_moving_mnist_byte_equal_to_jax():
    bank = tmm.synthetic_digit_bank()
    got = tmm.generate_moving_mnist(5, 4, 48, 3, digits=bank, seed=11)
    want = jmm.generate_moving_mnist(5, 4, 48, 3, digits=bank, seed=11)
    assert got.tobytes() == want.tobytes()


def test_a_changed_source_builds_into_a_new_directory(tmp_path):
    src = tmp_path / "hostio.cpp"
    shutil.copy(tbuild.SOURCE, src)
    first = tbuild.build(src, tmp_path / "b")
    assert first.parent.name.startswith("host-") and first.exists()
    assert tbuild.build(src, tmp_path / "b") == first     # reused
    src.write_text(src.read_text() + "\n// edited\n")
    second = tbuild.build(src, tmp_path / "b")
    assert second.exists() and second.parent != first.parent
    assert not list((tmp_path / "b").rglob("*.tmp*"))


def test_a_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        tbuild.build(tbuild.SOURCE, tmp_path, cxx="no-such-compiler-xyz")
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" void f( {\n")
    with pytest.raises(RuntimeError, match="error"):
        tbuild.build(bad, tmp_path)
    assert not [p for p in tmp_path.rglob("*") if p.is_file()
                and p.suffix != ".cpp"]


def test_the_library_is_built_from_the_ports_own_source():
    pkg = os.path.dirname(os.path.dirname(tbuild.__file__))
    assert str(tbuild.SOURCE).startswith(pkg)
    assert str(tbuild.build_dir()).startswith(os.path.join(pkg, "_build"))
    lib = tbuild.load_hostio()
    assert lib is tbuild.load_hostio()
