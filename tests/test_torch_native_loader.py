"""The port's native C++ decoder and decode pool (`io/native_loader.py`), held
against the JAX package's PIL decode and the port's own.

PNGs come from `sim/oxford_files.write_sequence` at the Oxford width (400 x
3,779 columns) with `SlamConfig()`'s 2,025 clipped bins.  Bounds: power
bytes, valid flags and timestamps exact; azimuths within 1e-6 rad (the C++
decoder scales the encoder ticks in double, PIL in float32); the float API
equal to its own u8 bytes times float32(1/255) and within 1 ulp of PIL's
division by 255; the driver over PNGs equal bit for bit to the same driver
fed the written frames through `frame_source`.  Only the JAX package's PIL
decode is called: its native loader rebuilds a tracked file in place.

Skips only where g++ or libpng's headers are missing, with g++'s message.
"""

import collections
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.io import oxford as joxford
from radarslampy_tpu_torch import RadarSlamSystem
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.io import native_loader, oxford
from radarslampy_tpu_torch.models import system as TS
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.sim import oxford_files

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 6
SEQ = "synth"
# the small grid of tests/test_torch_system.py for the driver
KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
FIELDS = ("power", "azimuths", "valid", "timestamps", "frame_timestamp")
Frame = collections.namedtuple("Frame", "power frame_timestamp")


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH")
    if not native_loader.native_available():
        pytest.skip(f"the native loader does not build here: {native_loader.build_log[:500]}")
    return native_loader


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """N frames of a 1.8 m / 0.04 rad arc at the small grid, written as PNGs."""
    root = tmp_path_factory.mktemp("oxford_native")
    cfg = SlamConfig(**KW)
    poses = np.zeros((N, 3))
    for t in range(1, N):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [1.8 * np.cos(th), 1.8 * np.sin(th), 0.04]
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for _, s in fd.render_sequence(np.random.default_rng(7), poses, cfg,
                                                      n_landmarks=1200, with_distortion=True,
                                                      noise=0.01)])
    stamps = oxford_files.write_sequence(str(root), SEQ, poses, cfg, frames)
    sp = oxford.sequence_paths(str(root), SEQ)
    return dict(root=str(root), frames=frames, stamps=stamps,
                paths=oxford.radar_image_paths(sp["radar"], sp["timestamps"]))


def test_written_pngs_have_the_oxford_width(seq):
    from PIL import Image

    cfg = SlamConfig()
    with Image.open(seq["paths"][0]) as im:
        assert im.size == (11 + cfg.num_range_bins, cfg.num_azimuths) == (3779, 400)
        assert im.mode == "L"
    assert cfg.clipped_range_bins == 2025


@pytest.mark.parametrize("frame", [0, 3])
def test_native_u8_decode_equals_pil(native, seq, frame):
    cfg, jcfg = SlamConfig(), JaxConfig()
    path = seq["paths"][frame]
    nat = native.decode_radar_png_native(path, cfg, raw_u8=True)
    written = seq["frames"][frame].copy()
    written[:, cfg.clipped_range_bins:] = 0
    np.testing.assert_array_equal(nat.power, written)
    for ref in (joxford.decode_radar_png(path, jcfg, raw_u8=True),
                oxford.decode_radar_png(path, cfg, raw_u8=True)):
        assert nat.power.dtype == ref.power.dtype == np.uint8
        np.testing.assert_array_equal(nat.power, ref.power)
        np.testing.assert_array_equal(nat.timestamps, ref.timestamps)
        np.testing.assert_array_equal(nat.valid, ref.valid)
        assert nat.frame_timestamp == ref.frame_timestamp == seq["stamps"][frame]
        assert nat.azimuths.dtype == ref.azimuths.dtype == np.float32
        np.testing.assert_allclose(nat.azimuths, ref.azimuths, atol=1e-6, rtol=0)


def test_native_float_decode(native, seq):
    """The float API equals its own u8 bytes times float32(1/255), as
    tests/test_system.py holds the JAX package's, and PIL's /255 to 1 ulp."""
    cfg, jcfg = SlamConfig(), JaxConfig()
    path = seq["paths"][1]
    nat = native.decode_radar_png_native(path, cfg)
    u8 = native.decode_radar_png_native(path, cfg, raw_u8=True)
    assert nat.power.dtype == np.float32
    np.testing.assert_array_equal(nat.power,
                                  u8.power.astype(np.float32) * np.float32(1.0 / 255.0))
    for ref in (joxford.decode_radar_png(path, jcfg), oxford.decode_radar_png(path, cfg)):
        np.testing.assert_array_max_ulp(nat.power, ref.power, maxulp=1)
        np.testing.assert_array_equal(nat.timestamps, ref.timestamps)


@pytest.mark.parametrize("raw_u8", [True, False], ids=["u8", "float"])
@pytest.mark.parametrize("workers,depth", [(4, 8), (1, 1), (3, 2)])
def test_loader_order_and_contents_equal_the_prefetcher(native, seq, raw_u8, workers, depth):
    cfg = SlamConfig()
    got = list(native.NativeLoader(seq["paths"], cfg, workers=workers, depth=depth,
                                   raw_u8=raw_u8))
    ref = list(TS._Prefetcher(seq["paths"], cfg, raw_u8=raw_u8))
    assert len(got) == len(ref) == N
    assert [f.frame_timestamp for f in got] == list(seq["stamps"])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_allclose(a.azimuths, b.azimuths, atol=1e-6, rtol=0)
        if raw_u8:
            np.testing.assert_array_equal(a.power, b.power)
        else:
            np.testing.assert_array_max_ulp(a.power, b.power, maxulp=1)


@pytest.mark.parametrize("bad", ["missing", "corrupt", "narrow"])
def test_bad_file_raises(native, seq, tmp_path, bad):
    """A missing file, bytes that are no PNG, and a PNG narrower than the
    Oxford width (2,036 columns: the decoder refuses it) raise IOError, from
    the single decode and from the pool at that frame."""
    cfg = SlamConfig()
    path = tmp_path / f"{seq['stamps'][-1] + 1}.png"
    if bad == "corrupt":
        path.write_bytes(b"not a png at all")
    elif bad == "narrow":
        from PIL import Image

        Image.fromarray(np.zeros((cfg.num_azimuths, 11 + cfg.clipped_range_bins),
                                 np.uint8)).save(path)
    with pytest.raises(IOError, match="native decode failed"):
        native.decode_radar_png_native(str(path), cfg, raw_u8=True)
    it = iter(native.NativeLoader([seq["paths"][0], str(path)], cfg, raw_u8=True))
    assert next(it).frame_timestamp == seq["stamps"][0]
    with pytest.raises(IOError, match="frame 1"):
        next(it)


def _leaves(state):
    return list(state[:-2]) + list(state.map) + [state.frame_idx]


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_driver_over_pngs_equals_frame_source(native, seq, monkeypatch, decoder):
    """The driver decodes with the native pool where it builds, with
    `_Prefetcher` otherwise; either way it equals the same run fed the
    written frames, bit for bit."""
    cfg = SlamConfig(**KW)
    made = []

    class Recording(native.NativeLoader):
        def __init__(self, *a, **k):
            made.append(a[0])
            super().__init__(*a, **k)

    monkeypatch.setattr(TS, "NativeLoader", Recording)
    if decoder == "pil":
        monkeypatch.setattr(TS, "native_available", lambda: False)
    res = RadarSlamSystem(SEQ, seq["root"], cfg, device="cpu").run()
    assert made == ([seq["paths"]] if decoder == "native" else [])
    ref = RadarSlamSystem(SEQ, seq["root"], cfg, device="cpu").run(
        frame_source=[Frame(f, int(t)) for f, t in zip(seq["frames"], seq["stamps"])],
        end=N - 1)
    assert res.frames == ref.frames == N
    for a, b in zip(res.trajectory.as_arrays(), ref.trajectory.as_arrays()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(res.final_state), _leaves(ref.final_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_driver_raises_on_a_native_decode_failure(native, seq, tmp_path):
    """A loader that builds but cannot decode a frame raises; the driver does
    not fall back to PIL (which would raise on this file too, but later and
    from another path)."""
    root = tmp_path / "broken"
    shutil.copytree(Path(seq["root"]) / SEQ, root / SEQ)
    Path(oxford.radar_image_paths(str(root / SEQ / "radar"),
                                  str(root / SEQ / "radar.timestamps"))[2]).write_bytes(b"x")
    with pytest.raises(IOError, match="native decode failed at frame 2"):
        RadarSlamSystem(SEQ, str(root), SlamConfig(**KW), device="cpu").run()


def test_concurrent_builds_leave_one_library(native, tmp_path):
    """Two processes that build into one empty directory at once leave one
    complete library, its log and no temporary file; the library loads."""
    code = ("import sys; from radarslampy_tpu_torch.io import native_loader as n; "
            "print(n.build_library(sys.argv[1]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = {Path(o.strip()) for o, _ in outs}
    assert len(built) == 1
    lib = built.pop()
    assert sorted(p.name for p in tmp_path.iterdir()) == [lib.with_suffix(".log").name, lib.name]
    import ctypes

    assert hasattr(ctypes.CDLL(str(lib)), "rsl_loader_create")
    # a third build finds it and compiles nothing
    assert native.build_library(tmp_path) == lib
