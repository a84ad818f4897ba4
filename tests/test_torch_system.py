"""The port's driver (`RadarSlamSystem`, the CLI), its Oxford decode and its
checkpoints, held against the JAX package on a synthetic PNG sequence.

The sequence: 8 frames along a 1.8 m / 0.04 rad-per-frame arc (off the 2.0 m
keyframe threshold, see tests/test_torch_frontend.py), rendered with motion
distortion, quantised to u8 and written as Oxford PNGs with a GT CSV that
chains to the rendered poses.  Config: the small grid of
tests/test_torch_frontend.py (256 px at 16 bins/px, 256 candidates, 16
keyframes).  Bounds: decode, GT and the metrics' keys and flags exact;
trajectories of the two drivers, each carrying its own state, within
`LM_CASES` of tests/test_torch_sequence.py at each LM budget (measured gaps
here: 1.1e-3 m / 5e-6 rad at 8 steps, 4.9e-4 m / 4.5e-6 rad at 30); the step
from a checkpoint carried across within the identical-state bound of
tests/test_torch_frontend.py (1e-3 m, 1e-4 rad; measured 1.0e-4 m); the
port's resume equal to its straight run bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.io import oxford as joxford
from radarslampy_tpu.models import system as JS
from radarslampy_tpu.models import trajectory as jtraj
from radarslampy_tpu.utils import checkpoint as jckpt
from radarslampy_tpu_torch import RadarSlamSystem
from radarslampy_tpu_torch.__main__ import main as port_main
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import slam_state_from_numpy
from radarslampy_tpu_torch.io import oxford
from radarslampy_tpu_torch.models import frontend as TF
from radarslampy_tpu_torch.models import system as TS
from radarslampy_tpu_torch.models import trajectory
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.sim import oxford_files
from radarslampy_tpu_torch.utils import checkpoint
from tests.test_torch_sequence import LM_CASES

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
N = 8
SEQ = "synth"
# the summary keys of `python -m radarslampy_tpu` without back-end flags
# (radarslampy_tpu/__main__.py, `summary`)
JAX_CLI_KEYS = ["sequence", "frames", "keyframes", "fps", "rmse_vs_gt_m"]


def _arc():
    poses = np.zeros((N + 1, 3))  # the last frame follows the sequence
    for t in range(1, N + 1):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [1.8 * np.cos(th), 1.8 * np.sin(th), 0.04]
    return poses


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("oxford")
    cfg = SlamConfig(**KW)
    poses = _arc()
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for _, s in fd.render_sequence(np.random.default_rng(1234), poses, cfg,
                                                      n_landmarks=1200, with_distortion=True,
                                                      noise=0.01)])
    poses, frames, after = poses[:N], frames[:N], frames[N]
    stamps = oxford_files.write_sequence(str(root), SEQ, poses, cfg, frames)
    return dict(root=str(root), poses=poses, frames=frames, after=after, stamps=stamps,
                paths=oxford.radar_image_paths(*(oxford.sequence_paths(str(root), SEQ)[k]
                                                 for k in ("radar", "timestamps"))))


def _cfgs(**kw):
    return SlamConfig(**KW, **kw), JaxConfig(**KW, **kw)


def _leaves(state):
    return list(state[:-2]) + list(state.map) + [state.frame_idx]


def test_decode_and_gt_equal_jax(seq):
    cfg, jcfg = _cfgs()
    sp = oxford.sequence_paths(seq["root"], SEQ)
    assert sp == joxford.sequence_paths(seq["root"], SEQ)
    assert seq["paths"] == joxford.radar_image_paths(sp["radar"], sp["timestamps"])
    assert len(seq["paths"]) == N
    for raw_u8 in (True, False):
        for path in seq["paths"][:2]:
            a = oxford.decode_radar_png(path, cfg, raw_u8=raw_u8)
            b = joxford.decode_radar_png(path, jcfg, raw_u8=raw_u8)
            assert a.frame_timestamp == b.frame_timestamp
            for f in ("power", "azimuths", "valid", "timestamps"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, f)
    u8 = oxford.decode_radar_png(seq["paths"][3], cfg, raw_u8=True)
    np.testing.assert_array_equal(u8.power, seq["frames"][3])
    gt, jgt = oxford.load_gt_trajectory(sp["gt"]), joxford.load_gt_trajectory(sp["gt"])
    for x, y in zip(gt, jgt):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(gt[0], seq["stamps"])
    np.testing.assert_allclose(gt[1], seq["poses"], atol=1e-12)
    # the trajectory container and its ATE
    est = seq["poses"] + np.random.default_rng(0).normal(0, 0.1, seq["poses"].shape)
    q = seq["stamps"][:-1] + 1000
    a, b = (m.Trajectory(seq["stamps"], est) for m in (trajectory, jtraj))
    np.testing.assert_array_equal(a.pose_at_times(q), b.pose_at_times(q))
    ga, gb = (m.Trajectory(gt[0], gt[1]) for m in (trajectory, jtraj))
    assert trajectory.align_and_rmse(ga, a)[0] == jtraj.align_and_rmse(gb, b)[0]


@pytest.fixture(scope="module", params=LM_CASES, ids=lambda c: f"lm{c[0]}")
def drivers(request, seq, tmp_path_factory):
    """Both drivers over the PNGs (the port through its own decode, the JAX
    driver through its PIL prefetcher), each writing metrics and a final
    checkpoint."""
    it, atol_m, atol_rad = request.param
    cfg, jcfg = _cfgs(mds_iterations=it)
    tmp = tmp_path_factory.mktemp(f"drivers{it}")
    outs = []
    port = RadarSlamSystem(SEQ, seq["root"], cfg, progress=lambda n, o: outs.append(o),
                           device="cpu")
    res = port.run(metrics_path=str(tmp / "m.jsonl"), checkpoint_dir=str(tmp / "ck"))
    jsys = JS.RadarSlamSystem(SEQ, seq["root"], jcfg)
    jres = jsys.run(end=N - 1, frame_source=JS._Prefetcher(seq["paths"], jcfg, raw_u8=True),
                    metrics_path=str(tmp / "jm.jsonl"), checkpoint_dir=str(tmp / "jck"))
    return dict(cfg=cfg, jcfg=jcfg, tmp=tmp, port=port, res=res, outs=outs, jsys=jsys,
                jres=jres, atol_m=atol_m, atol_rad=atol_rad)


def _records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def test_driver_matches_jax_driver(drivers):
    d = drivers
    res, jres = d["res"], d["jres"]
    assert res.frames == jres.frames == N
    assert res.n_keyframes == jres.n_keyframes
    recs, jrecs = _records(d["tmp"] / "m.jsonl"), _records(d["tmp"] / "jm.jsonl")
    assert len(recs) == N - 1
    assert [list(r) for r in recs] == [list(r) for r in jrecs]
    for k in ("frame", "timestamp", "is_keyframe", "did_retrack"):
        assert [r[k] for r in recs] == [r[k] for r in jrecs], k
    assert {r["is_keyframe"] for r in recs} == {True, False}
    assert sum(r["is_keyframe"] for r in recs) == res.n_keyframes - 1
    assert [r["n_inliers"] for r in recs] == [int(o.n_inliers) for o in d["outs"]]
    assert res.min_inliers == min(r["n_inliers"] for r in recs)
    assert res.n_fit_failures == sum(not r["fit_ok"] for r in recs)
    ts, est = res.trajectory.as_arrays()
    jts, jest = jres.trajectory.as_arrays()
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(est[:, :2], jest[:, :2], atol=d["atol_m"], rtol=0)
    np.testing.assert_allclose(est[:, 2], jest[:, 2], atol=d["atol_rad"], rtol=0)
    assert np.isfinite(res.rmse_vs_gt) and res.rmse_vs_gt < 1.0
    assert res.fps > 0


def test_resume_equals_straight_run(seq, drivers, tmp_path):
    """A run checkpointed mid-sequence and resumed ends where the straight
    run ends, bit for bit (tests/test_checkpoint_viz.py's resume test on the
    port): both from a run that stops at frame 4 and from the mid-run
    checkpoint a longer run writes every 3 frames."""
    cfg, straight = drivers["cfg"], drivers["res"]
    ck, mid, snap = str(tmp_path / "ck"), str(tmp_path / "mid"), str(tmp_path / "snap")

    def snapshot(n, out):  # called before frame n's checkpoint, after frame n-1's
        if n == 4:
            shutil.copytree(mid, snap)

    first = RadarSlamSystem(SEQ, seq["root"], cfg, device="cpu").run(0, 4, checkpoint_dir=ck)
    assert first.frames == 5
    assert checkpoint.load_meta(ck) == {"next_frame_index": 5}
    RadarSlamSystem(SEQ, seq["root"], cfg, progress=snapshot, device="cpu").run(
        checkpoint_dir=mid, checkpoint_every=3)
    assert checkpoint.load_meta(snap) == {"next_frame_index": 4}
    for path, n_rest in ((ck, 3), (snap, 4)):
        resumed = RadarSlamSystem(SEQ, seq["root"], cfg, device="cpu").run(
            end=N - 1, resume_from=path)
        assert resumed.frames == n_rest
        np.testing.assert_array_equal(resumed.trajectory.as_arrays()[0],
                                      straight.trajectory.as_arrays()[0])
        np.testing.assert_array_equal(resumed.trajectory.as_arrays()[1],
                                      straight.trajectory.as_arrays()[1])
        for a, b in zip(_leaves(resumed.final_state), _leaves(straight.final_state)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="nothing to resume"):
        RadarSlamSystem(SEQ, seq["root"], cfg, device="cpu").run(end=3, resume_from=ck)


def test_checkpoint_crosses_both_ways(seq, drivers):
    d = drivers
    cfg, jcfg, tmp = d["cfg"], d["jcfg"], d["tmp"]
    # JAX -> port: the same leaves as interop's carry of the JAX final state
    state, traj = checkpoint.load_state(str(tmp / "jck"), cfg, "cpu")
    carried = slam_state_from_numpy(jax.device_get(d["jres"].final_state), cfg, "cpu")
    for a, b in zip(_leaves(state), _leaves(carried)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(traj[1], d["jres"].trajectory.as_arrays()[1])
    assert checkpoint.load_meta(str(tmp / "jck")) == {"next_frame_index": N}
    # ... and the step on the frame after the sequence agrees with JAX's
    frame = seq["after"]
    _, out = TF.slam_step(state, frame, d["port"].maps, cfg)
    jstate, _ = jckpt.load_state(str(tmp / "jck"), d["jsys"]._state_template())
    _, jout, _ = d["jsys"]._row_step_fn(jstate, frame, d["jsys"].maps)
    for f in ("is_keyframe", "did_retrack", "n_inliers", "n_tracked", "fit_ok"):
        assert getattr(out, f).item() == np.asarray(getattr(jout, f)).item(), f
    dp = np.abs(out.pose.numpy() - np.asarray(jout.pose))
    assert dp[:2].max() < 1e-3 and dp[2] < 1e-4, dp
    # port -> JAX, leaf for leaf, in the shapes and dtypes of the JAX state
    template = d["jsys"]._state_template()
    jleaves, jtr = jckpt.load_state(str(tmp / "ck"), template)
    for a, b, t in zip(_leaves(d["res"].final_state), jax.tree_util.tree_leaves(jleaves),
                       jax.tree_util.tree_leaves(template)):
        assert np.asarray(b).dtype == t.dtype and np.asarray(b).shape == t.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(jtr[1], d["res"].trajectory.as_arrays()[1])


def test_load_state_refuses_a_foreign_layout(drivers, tmp_path):
    d = drivers
    other = SlamConfig(**dict(KW, max_keyframes=32))
    with pytest.raises(ValueError, match="map.poses"):
        checkpoint.load_state(str(d["tmp"] / "ck"), other, "cpu")
    bad = tmp_path / "bad"
    shutil.copytree(d["tmp"] / "ck", bad)
    (bad / "treedef.json").write_text(json.dumps({"format_version": 1, "n_leaves": 21}))
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        checkpoint.load_state(str(bad), d["cfg"], "cpu")


def test_prefetcher_propagates_decode_errors(tmp_path):
    """tests/test_checkpoint_viz.py's decode-error test on the port."""
    cfg = SlamConfig(**KW)
    with pytest.raises(IOError):
        next(iter(TS._Prefetcher([str(tmp_path / "missing.png")], cfg, raw_u8=True)))
    corrupt = tmp_path / "corrupt.png"
    corrupt.write_bytes(b"not a png at all")
    with pytest.raises(IOError):
        next(iter(TS._Prefetcher([str(corrupt)], cfg, raw_u8=True)))


@pytest.mark.parametrize("kw", [dict(optimize=True), dict(ba=True), dict(backend_every=4),
                                dict(viz_dir="viz")], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(seq, kw):
    sys_ = RadarSlamSystem(SEQ, seq["root"], SlamConfig(**KW), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sys_.run(**kw)


def test_driver_defaults_to_cuda(seq):
    if torch.cuda.is_available():
        assert RadarSlamSystem(SEQ, seq["root"], SlamConfig(**KW)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RadarSlamSystem(SEQ, seq["root"], SlamConfig(**KW))


def test_cli_prints_the_jax_summary(seq, tmp_path):
    out_dir, metrics, ck = tmp_path / "out", tmp_path / "m.jsonl", tmp_path / "ck"
    run = subprocess.run(
        [sys.executable, "-m", "radarslampy_tpu_torch", SEQ, "0", "5", "--data-root",
         seq["root"], "--cart-size", "256", "--cpu", "--metrics", str(metrics),
         "--checkpoint-dir", str(ck), "--out-dir", str(out_dir)],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    assert list(summary) == JAX_CLI_KEYS
    assert summary["sequence"] == SEQ and summary["frames"] == 6
    assert summary["rmse_vs_gt_m"] is not None and summary["rmse_vs_gt_m"] < 1.0
    assert json.loads((out_dir / "summary.json").read_text()) == summary
    with np.load(out_dir / "trajectory.npz") as t:
        np.testing.assert_array_equal(t["timestamps"], seq["stamps"][:6])
        assert t["poses"].shape == (6, 3)
    assert len(_records(metrics)) == 5
    assert checkpoint.load_meta(str(ck)) == {"next_frame_index": 6}
    with pytest.raises(NotImplementedError):
        port_main([SEQ, "--data-root", seq["root"], "--cart-size", "256", "--cpu",
                   "--loop-closure"])
