"""The port's figures (`viz/plots.py`), the driver's `viz_dir` and the CLI's
`--out-dir` / `--viz-dir`, held against the JAX package's.

Sequence: 7 frames along a 1.8 m / 0.04 rad-per-frame arc (off the 2.0 m
keyframe threshold), written as Oxford PNGs with a GT CSV and a GPS CSV (the
GT track at five fixes per scan, rotated and shifted into UTM-like
coordinates, with 0.05 m of noise).  Config: the CLI's `--cart-size 256`
(`SlamConfig(cart_size=256, cart_downsample=16)`, 12 LM steps), so the JAX
driver compiles once for the whole file.  The JAX driver is fed through its
PIL `_Prefetcher` (its native loader rebuilds a tracked file in place).

Bounds: frame indices, titles, GT points, `feat_mask` exact; the composites'
trajectory points and the GPS overlay within the 8-step bound of
tests/test_torch_sequence.py (`LM_CASES[0]`; 12 steps converge closer);
`prev_cart` within 1e-5 and `feat_px` within 1e-2 px (the warp's and KLT's
float-order differences).  Measured gaps: `prev_cart` 6.0e-8, `feat_px`
9.2e-5 px, trajectory 6.4e-4 m, GPS overlay 7.2e-4 m.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from radarslampy_tpu.__main__ import main as jax_main
from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.io import native_loader as jnative
from radarslampy_tpu.models import system as JS
from radarslampy_tpu.viz import plots as jplots
from radarslampy_tpu_torch import RadarSlamSystem
from radarslampy_tpu_torch.__main__ import main as port_main
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.io import oxford
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.sim import oxford_files
from radarslampy_tpu_torch.viz import plots
from tests.test_torch_sequence import LM_CASES

torch.set_num_threads(1)

N = 7
SEQ = "synth"
KW = dict(cart_size=256, cart_downsample=16)
ATOL_M = LM_CASES[0][1]
GPS_ROT, GPS_OFFSET = 0.7, np.array([619_000.0, 5_735_000.0])   # easting, northing


def _arc(n):
    poses = np.zeros((n, 3))
    for t in range(1, n):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [1.8 * np.cos(th), 1.8 * np.sin(th), 0.04]
    return poses


def _write_gps(path, stamps, poses, rng):
    """An Oxford gps.csv: timestamp at column 0, northing at 8, easting at 9."""
    t = np.linspace(stamps[0] - 100_000, stamps[-1] + 100_000, 5 * len(stamps))
    xy = np.stack([np.interp(t, stamps, poses[:, 0]), np.interp(t, stamps, poses[:, 1])], 1)
    c, s = np.cos(GPS_ROT), np.sin(GPS_ROT)
    en = xy @ np.array([[c, -s], [s, c]]).T + GPS_OFFSET + rng.normal(0, 0.05, xy.shape)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("timestamp,latitude,longitude,altitude,latitude_sigma,longitude_sigma,"
                "altitude_sigma,northing,easting,down,utm_zone\n")
        for ti, (e, n) in zip(t.astype(np.int64), en):
            f.write(f"{ti},0,0,0,0,0,0,0,{n:.6f},{e:.6f},0,30U\n")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("oxford_viz")
    cfg = SlamConfig(**KW)
    poses = _arc(N)
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for _, s in fd.render_sequence(np.random.default_rng(11), poses, cfg,
                                                      n_landmarks=1200, with_distortion=True,
                                                      noise=0.01)])
    stamps = oxford_files.write_sequence(str(root), SEQ, poses, cfg, frames)
    sp = oxford.sequence_paths(str(root), SEQ)
    _write_gps(sp["gps"], stamps, poses, np.random.default_rng(5))
    return dict(root=str(root), stamps=stamps,
                paths=oxford.radar_image_paths(sp["radar"], sp["timestamps"]))


@pytest.fixture
def jax_pil_decode(monkeypatch):
    """The JAX driver and CLI decode with PIL: its native loader would
    rebuild radarslampy_tpu/io/native/libradar_loader.so in place."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)


@pytest.mark.parametrize("n", [2, 5, 40])
def test_align_xy_matches_jax(n):
    rng = np.random.default_rng(n)
    src = rng.normal(0, 20, (n, 2))
    th = rng.uniform(-np.pi, np.pi)
    dst = src @ np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).T + [3, -4]
    dst = dst[: max(2, n - 1)] + rng.normal(0, 0.1, (max(2, n - 1), 2))
    got, ref = plots.align_xy(src, dst), jplots.align_xy(src, dst)
    assert got.shape == src.shape
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)


def test_plots_write_files(tmp_path):
    """tests/test_checkpoint_viz.py's plot test on the port, and the
    composite; without ffmpeg no mp4 is made, as in the JAX package."""
    rng = np.random.default_rng(1234)
    est = np.cumsum(rng.random((20, 3)), axis=0)
    gt = est + rng.normal(0, 0.1, est.shape)
    p1 = tmp_path / "traj.jpg"
    plots.plot_trajectories(gt, est, rmse=1.23, save_path=str(p1), gps_xy=gt[:, :2] + 0.5)
    img = rng.random((64, 64))
    pts = rng.random((10, 2)) * 64
    p2 = tmp_path / "track.jpg"
    plots.plot_tracking(img, img, pts, pts + 1.0, save_path=str(p2))
    p3 = tmp_path / "map.jpg"
    plots.plot_map(rng.random((100, 2)) * 50, rng.random(100) > 0.2, est_poses=est,
                   subsample=1, save_path=str(p3))
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, gt_xy in enumerate((gt[:, :2], None)):
        plots.plot_frame_composite(img, pts, rng.random(10) > 0.3, gt_xy, est[:, :2],
                                   str(frames / f"frame_{i:06d}.jpg"), title=f"frame {i}")
    for p in (p1, p2, p3, *frames.iterdir()):
        assert os.path.getsize(p) > 1000, p
    fig, ax = plots.plot_trajectories(None, est)
    assert fig is not None and ax is not None
    mp4 = tmp_path / "run.mp4"
    made = plots.frames_to_mp4(str(frames), str(mp4))
    assert made == jplots.frames_to_mp4(str(frames), str(tmp_path / "jax.mp4"))
    assert made == mp4.exists()
    if shutil.which("ffmpeg") is None:
        assert made is False


def _record(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def test_run_viz_dir_matches_jax(seq, tmp_path, monkeypatch, jax_pil_decode):
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    port_calls, jax_calls = [], []
    _record(monkeypatch, plots, "plot_frame_composite", port_calls)
    _record(monkeypatch, jplots, "plot_frame_composite", jax_calls)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    res = RadarSlamSystem(SEQ, seq["root"], cfg, device="cpu").run(
        viz_dir=str(pdir), viz_every=3)
    jres = JS.RadarSlamSystem(SEQ, seq["root"], jcfg).run(
        end=N - 1, frame_source=JS._Prefetcher(seq["paths"], jcfg, raw_u8=True),
        viz_dir=str(jdir), viz_every=3)
    assert res.frames == jres.frames == N
    names = ["frame_000003.jpg", "frame_000006.jpg"]
    assert [os.path.basename(a[5]) for a, _ in port_calls] == names
    assert [os.path.basename(a[5]) for a, _ in jax_calls] == names
    for (a, ka), (b, kb) in zip(port_calls, jax_calls):
        assert ka == kb and ka["title"].startswith("frame ")
        img, pts, mask, gt_xy, est_xy = a[:5]
        jimg, jpts, jmask, jgt_xy, jest_xy = b[:5]
        assert img.shape == jimg.shape == (cfg.cart_size, cfg.cart_size)
        np.testing.assert_allclose(img, jimg, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(mask, jmask)
        np.testing.assert_allclose(pts[mask], jpts[jmask], atol=1e-2, rtol=0)
        np.testing.assert_array_equal(gt_xy, jgt_xy)
        np.testing.assert_allclose(est_xy, jest_xy, atol=ATOL_M, rtol=0)
    for d in (pdir, jdir):
        assert sorted(p.name for p in d.iterdir()) == sorted(
            names + ["map.png"] + (["run.mp4"] if shutil.which("ffmpeg") else []))
        for name in names + ["map.png"]:
            assert os.path.getsize(d / name) > 1000


def test_run_without_matplotlib_fails_before_the_first_step(seq, tmp_path, monkeypatch):
    import radarslampy_tpu_torch.viz as viz_pkg

    monkeypatch.setitem(sys.modules, "radarslampy_tpu_torch.viz.plots", None)
    monkeypatch.delattr(viz_pkg, "plots")
    steps = []
    sys_ = RadarSlamSystem(SEQ, seq["root"], SlamConfig(**KW),
                           progress=lambda n, o: steps.append(n), device="cpu")
    with pytest.raises(ImportError):
        sys_.run(viz_dir=str(tmp_path / "viz"))
    assert steps == [] and not (tmp_path / "viz").exists()


def test_cli_out_dir_and_viz_dir_match_jax(seq, tmp_path, monkeypatch, capsys,
                                          jax_pil_decode):
    port_calls, jax_calls = [], []
    _record(monkeypatch, plots, "plot_trajectories", port_calls)
    _record(monkeypatch, jplots, "plot_trajectories", jax_calls)
    pout, jout, viz = tmp_path / "port", tmp_path / "jax", tmp_path / "viz"
    common = [SEQ, "--data-root", seq["root"], "--cart-size", "256"]
    assert port_main(common + ["--cpu", "--out-dir", str(pout), "--viz-dir", str(viz),
                               "--viz-every", "2"]) == 0
    assert jax_main(common + ["--out-dir", str(jout)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(port_calls) == len(jax_calls) == 1
    (pa, pk), (ja, jk) = port_calls[0], jax_calls[0]
    assert pk.keys() == jk.keys() == {"title", "rmse", "save_path", "gps_xy"}
    assert pk["title"] == jk["title"] == SEQ
    ts = np.asarray(seq["stamps"])
    np.testing.assert_array_equal(pa[0], ja[0])             # GT at the radar stamps
    np.testing.assert_allclose(pa[1], ja[1], atol=ATOL_M, rtol=0)
    assert pk["gps_xy"].shape == jk["gps_xy"].shape == (len(ts), 2)
    np.testing.assert_allclose(pk["gps_xy"], jk["gps_xy"], atol=ATOL_M, rtol=0)
    # the aligned GPS lies on the GT track (0.05 m of noise, plus the drift)
    assert np.abs(pk["gps_xy"] - pa[0][:, :2]).max() < 0.5
    for d in (pout, jout):
        assert os.path.getsize(d / "trajectory.jpg") > 1000
        assert (d / "summary.json").exists() and (d / "trajectory.npz").exists()
    assert sorted(p.name for p in viz.iterdir() if p.suffix == ".jpg") == [
        f"frame_{n:06d}.jpg" for n in (2, 4, 6)]
    assert (viz / "map.png").exists()
    assert '"frames": 7' in out[0]
