"""The port's host fast-ops library (mirage_tpu_torch/csrc/fastops.cpp,
built by ops/_build.py:build_host, bound in utils/native.py) and its
routing in data/augment.py.

Each entry point is held to the port's plain versions (resize_np_ref's
interpolation matrices, scipy's affine_transform behind affine_warp_ref,
numpy) with tests/test_native.py's bars: bilinear within 1e-5, nearest
resizes exact, u8 -> f32 within 1e-7, min-max within 1e-6, nearest-warped
label pixels equal at 99.5 % or more (scipy rounds the .5 boundary its own
way). Against the JAX package's library, compiled here from
native/fastops.cpp with native/Makefile's flags into a temporary
directory, every entry point is bit-equal. Nothing here builds into
native/: the JAX package's binding is only ever given that temporary
library through a patched ``_load``.
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.ndimage import affine_transform

from mirage_tpu_torch.data import augment
from mirage_tpu_torch.ops import _build
from mirage_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]


def jax_fastops(directory: Path) -> ctypes.CDLL:
    """native/fastops.cpp compiled with native/Makefile's CXX default and
    CXXFLAGS into ``directory``, loaded with the argtypes that
    mirage_tpu/utils/native.py:_load sets."""
    make = (ROOT / "native" / "Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", make, re.M).group(1).split()
    cxx = re.search(r"^CXX \?= (.*)$", make, re.M).group(1).strip()
    out = Path(directory) / "libmirage_fastops.so"
    if not out.exists():
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        subprocess.run([cxx, *flags, "-shared", "-o", str(tmp),
                        str(ROOT / "native" / "fastops.cpp")], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, l, i, f = (ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                  ctypes.c_float)
    lib.resize_bilinear_f32.argtypes = [p, p, l, l, l, l, l, i]
    lib.resize_nearest_i32.argtypes = [p, p, l, l, l, l, l]
    lib.u8_to_f32_scaled.argtypes = [p, p, l, f]
    lib.minmax_norm_f32.argtypes = [p, l, l]
    lib.affine_warp_f32.argtypes = [p, p, l, l, l, p, p, i, f]
    return lib


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return jax_fastops(tmp_path_factory.mktemp("jax_fastops"))


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------ against the plain versions

@pytest.mark.parametrize("shape,out,align", [
    ((3, 37, 53), (64, 48), False), ((2, 40, 40), (31, 57), False),
    ((50, 60), (64, 64), True), ((1, 2, 9, 7), (9, 20), False)])
def test_resize_bilinear_matches_the_plain_resize(shape, out, align):
    x = _rng(len(shape) + out[0]).random(shape).astype(np.float32)
    got = native.resize_bilinear(x, out, align)
    want = augment.resize_np_ref(x, out, "bilinear", align)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint8])
@pytest.mark.parametrize("shape,out", [((2, 33, 21), (17, 40)),
                                       ((496, 512), (1024, 1024)),
                                       ((128, 128), (96, 80))])
def test_resize_nearest_equals_the_plain_resize(dtype, shape, out):
    x = _rng(out[1]).integers(0, 9, shape).astype(dtype)
    got = native.resize_nearest(x, out)
    np.testing.assert_array_equal(
        got, augment.resize_np_ref(x, out, "nearest"))
    assert got.dtype == x.dtype


def test_u8_to_f32_and_minmax_match_numpy():
    rng = _rng(4)
    x = rng.integers(0, 256, (100, 100), dtype=np.uint8)
    np.testing.assert_allclose(native.u8_to_f32(x),
                               x.astype(np.float32) / 255.0, atol=1e-7)
    y = (rng.random((4, 16, 16)) * 50 + 3).astype(np.float32)
    want = augment.minmax_norm(y)
    got = native.minmax_norm_inplace(y)
    assert got is y
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("angle,translate,scale,shear", [
    (8.0, (3, -2), 1.05, 2.0), (-10.0, (0, 5), 0.9, (-5.0, 0.0)),
    (90.0, (0, 0), 1.0, 0.0)])
def test_affine_warp_matches_the_plain_warp(angle, translate, scale, shear):
    """Bilinear images within 1e-5, nearest label maps at 99.5 %, through
    augment.affine_warp (the library) and affine_warp_ref (scipy)."""
    rng = _rng(int(angle) + 20)
    img = rng.random((2, 48, 56)).astype(np.float32)
    kw = dict(order=1, fill=0.5)
    np.testing.assert_allclose(
        augment.affine_warp(img, angle, translate, scale, shear, **kw),
        augment.affine_warp_ref(img, angle, translate, scale, shear, **kw),
        atol=1e-5)
    labels = rng.integers(0, 7, (40, 40)).astype(np.int64)
    got = augment.affine_warp(labels, angle, translate, scale, shear,
                              order=0)
    want = augment.affine_warp_ref(labels, angle, translate, scale, shear,
                                   order=0)
    assert got.dtype == labels.dtype
    assert (got == want).mean() >= 0.995


@pytest.mark.parametrize("offset", [(-0.5, 0.0), (0.0, 0.49), (0.51, -0.3)])
def test_affine_warp_boundary_is_scipys_constant_mode(offset):
    """Sub-pixel shifts that put source coordinates in (-1, 0) and
    (n - 1, n): scipy's constant mode fills cval there with no blending,
    and so does the library (tests/test_native.py's offsets)."""
    x = _rng(5).random((3, 48, 48)).astype(np.float32)
    got = native.affine_warp(x, np.eye(2), np.asarray(offset), order=1,
                             cval=-7.0)
    want = np.stack([affine_transform(p, np.eye(2), offset=np.asarray(offset),
                                      order=1, mode="constant", cval=-7.0)
                     for p in x])
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------ the routing

def test_resize_np_and_affine_warp_route_as_the_jax_package(monkeypatch):
    """mirage_tpu/data/augment.py:36-65, :142-182: bilinear float32 and
    nearest integer resizes and every warp go to the library; other modes
    and dtypes take the plain resize; an unchanged size returns the input."""
    calls = []
    for name in ("resize_bilinear", "resize_nearest", "affine_warp"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rng = _rng(6)
    f32 = rng.random((2, 20, 24)).astype(np.float32)
    labels = rng.integers(0, 5, (20, 24))
    cases = [(f32, "bilinear", ["resize_bilinear"]),
             (labels, "nearest", ["resize_nearest"]),
             (labels.astype(np.uint8), "nearest", ["resize_nearest"]),
             (f32.astype(np.float64), "bilinear", []),
             (f32, "nearest", []), (f32, "bicubic", []),
             (labels, "bilinear", [])]
    for x, mode, route in cases:
        calls.clear()
        got = augment.resize_np(x, (31, 17), mode=mode)
        assert calls == route, (x.dtype, mode)
        want = augment.resize_np_ref(x, (31, 17), mode=mode)
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), atol=1e-5)
        assert got.dtype == x.dtype
    calls.clear()
    assert augment.resize_np(f32, (20, 24)) is f32 and calls == []
    augment.affine_warp(labels, 5.0, (1, 1), 1.0, 0.0, order=0)
    augment.affine_warp(f32, 5.0, (1, 1), 1.0, 0.0)
    assert calls == ["affine_warp", "affine_warp"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16,
                                   np.uint8, np.int32, np.int64, np.bool_])
def test_dtype_gates_match_jax(monkeypatch, jax_lib, dtype):
    """Each function declines (None) exactly the dtypes the JAX binding
    declines, given the same library."""
    from mirage_tpu.utils import native as jax_native

    monkeypatch.setattr(jax_native, "_load", lambda: jax_lib)
    x = (_rng(7).random((2, 12, 10)) * 3).astype(dtype)
    for name, args in (("resize_bilinear", ((7, 9),)),
                       ("resize_nearest", ((7, 9),)), ("u8_to_f32", ()),
                       ("minmax_norm_inplace", ())):
        want = getattr(jax_native, name)(x.copy(), *args)
        got = getattr(native, name)(x.copy(), *args)
        assert (got is None) == (want is None), name
    strided = np.zeros((2, 12, 20), np.float32)[..., ::2]
    assert native.minmax_norm_inplace(strided) is None
    assert jax_native.minmax_norm_inplace(strided) is None


# ------------------------------------------ bit-equal to the JAX library

def _ptr(a):
    return a.ctypes.data


def test_every_entry_point_is_bit_equal_to_the_jax_library(jax_lib):
    """The port's binding against native/fastops.cpp's C entry points
    called directly: the same source compiled with the same flags."""
    rng = _rng(8)
    x = rng.random((3, 37, 53)).astype(np.float32)
    for align in (0, 1):
        want = np.empty((3, 64, 48), np.float32)
        jax_lib.resize_bilinear_f32(_ptr(x), _ptr(want), 3, 37, 53, 64, 48,
                                    align)
        np.testing.assert_array_equal(
            native.resize_bilinear(x, (64, 48), bool(align)), want)
    lab = rng.integers(0, 9, (2, 33, 21)).astype(np.int32)
    want = np.empty((2, 17, 40), np.int32)
    jax_lib.resize_nearest_i32(_ptr(lab), _ptr(want), 2, 33, 21, 17, 40)
    np.testing.assert_array_equal(native.resize_nearest(lab, (17, 40)), want)
    u8 = rng.integers(0, 256, (50, 70), dtype=np.uint8)
    want = np.empty(u8.shape, np.float32)
    jax_lib.u8_to_f32_scaled(_ptr(u8), _ptr(want), u8.size,
                             ctypes.c_float(1 / 255))
    np.testing.assert_array_equal(native.u8_to_f32(u8), want)
    y = (rng.random((4, 16, 16)) * 50 + 3).astype(np.float32)
    want = y.copy()
    jax_lib.minmax_norm_f32(_ptr(want), 4, 256)
    np.testing.assert_array_equal(native.minmax_norm_inplace(y.copy()), want)
    th = 0.31
    mat = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    off = np.array([3.7, -2.1])
    for order in (0, 1):
        mats = np.ascontiguousarray(np.broadcast_to(mat.reshape(4), (3, 4)))
        offs = np.ascontiguousarray(np.broadcast_to(off, (3, 2)))
        want = np.empty_like(x)
        jax_lib.affine_warp_f32(_ptr(x), _ptr(want), 3, 37, 53, _ptr(mats),
                                _ptr(offs), order, ctypes.c_float(0.25))
        np.testing.assert_array_equal(
            native.affine_warp(x, mat, off, order=order, cval=0.25), want)


# --------------------------------------------------------------- the build

def test_the_build_uses_the_host_compiler_into_build_not_native():
    lib = _build.build_host()
    assert lib == _build.BUILD_DIR / "libfastops.so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "mirage_tpu_torch")
    assert native.load().fastops_version() == 1
    assert _build.HOST_FLAGS == ("-O3", "-std=c++17", "-fPIC",
                                 "-march=native", "-pthread")


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/c++", "false"])
def test_a_failing_compiler_raises(monkeypatch, tmp_path, cxx):
    """A compiler that cannot run, or that fails, raises with the command
    and its output; nothing is left in the fresh build directory but the
    lock file."""
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=re.escape(cxx)):
        _build.build_host(build_dir=tmp_path / "b")
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == \
        ["libfastops.lock"]


def test_a_stale_library_is_rebuilt(tmp_path):
    lib = _build.build_host(build_dir=tmp_path)
    src = _build.CSRC / "fastops.cpp"
    old = src.stat().st_mtime - 100
    os.utime(lib, (old, old))
    assert _build.build_host(build_dir=tmp_path).stat().st_mtime > old
    kept = lib.stat().st_mtime
    assert _build.build_host(build_dir=tmp_path).stat().st_mtime == kept


def test_four_processes_at_once_leave_one_loadable_library(tmp_path):
    code = ("import ctypes, sys; from mirage_tpu_torch.ops import _build; "
            "p = _build.build_host(build_dir=sys.argv[1]); "
            "print(ctypes.CDLL(str(p)).fastops_version())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _ in outs] == ["1"] * 4
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["libfastops.lock", "libfastops.so"]
