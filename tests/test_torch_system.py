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

import collections
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


@pytest.mark.parametrize("kw", [dict(viz_dir="viz")], ids=lambda kw: next(iter(kw)))
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


def test_cli_prints_the_jax_summary(seq, tmp_path, capsys):
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
    # the back-end flags run (no loop on this short arc, so no pose-graph cost)
    capsys.readouterr()
    assert port_main([SEQ, "0", "5", "--data-root", seq["root"], "--cart-size", "256", "--cpu",
                      "--loop-closure", "--ba", "--backend-every", "2"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(summary) == JAX_CLI_KEYS + ["online_loops", "loop_closures", "ba_cost",
                                            "ba_landmarks"]
    assert summary["online_loops"] == summary["loop_closures"] == 0
    assert np.isfinite(summary["ba_cost"]) and summary["ba_landmarks"] > 0


# ---- the back-end on a closed loop ----
# 49 frames on a circle of 40 frames a turn, 2.2 m chords (every frame a
# keyframe, clear of the 2.0 m threshold), so keyframes 40-48 revisit 0-8; the
# online pass runs at steps 24 and 48 and the second one closes loops.  Map
# capacity 64 keyframes, 128 features.  The online pass pads the map to 1024
# rows, so each of its LM iterations is a dense 3072 x 3072 solve on the CPU:
# 3 iterations keep the tests short.
LOOP_KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, k_max=128,
               max_keyframes=64, pg_iterations=3)
LOOP_N, LOOP_B = 49, 24
LOOP_SEQ = "loop"
Frame = collections.namedtuple("Frame", "power frame_timestamp")
# the back-end on one shared state: pose graph (and the state re-anchored by
# it) as tests/test_torch_posegraph.py, BA as tests/test_torch_ba.py
PG_M, PG_RAD, BA_M, BA_RAD = 1e-3, 1e-4, 5e-3, 5e-4


def _circle(n, per_turn=40, chord=2.2):
    radius = chord / (2 * np.sin(np.pi / per_turn))
    th = np.arange(n) * 2 * np.pi / per_turn
    return np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], 1)


@pytest.fixture(scope="module")
def loop_seq(tmp_path_factory):
    """The loop's frames (u8) and a sequence directory with its timestamps and
    GT; both drivers take the frames through `frame_source`."""
    root = tmp_path_factory.mktemp("loop")
    cfg = SlamConfig(**LOOP_KW)
    poses = _circle(LOOP_N)
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for _, s in fd.render_sequence(np.random.default_rng(7), poses, cfg,
                                                      n_landmarks=1200, with_distortion=True,
                                                      noise=0.01)])
    stamps = oxford_files.write_sequence(str(root), LOOP_SEQ, poses, cfg)
    return dict(root=str(root), poses=poses, frames=frames, stamps=stamps)


def _frames(loop_seq):
    return [Frame(f, int(t)) for f, t in zip(loop_seq["frames"], loop_seq["stamps"])]


@pytest.fixture(scope="module")
def loop_runs(loop_seq, tmp_path_factory):
    """The JAX driver with the back-end on (and one more JAX online pass over
    its final state, from an empty back-end state), then the port's driver on
    the same frames."""
    from radarslampy_tpu.models import loopclosure as jlc

    cfg, jcfg = SlamConfig(**LOOP_KW), JaxConfig(**LOOP_KW)
    kw = dict(optimize=True, ba=True, backend_every=LOOP_B)
    jres = JS.RadarSlamSystem(LOOP_SEQ, loop_seq["root"], jcfg).run(
        frame_source=_frames(loop_seq), **kw)
    jinc = jlc.incremental_backend(jres.final_state, jcfg)
    tmp = tmp_path_factory.mktemp("loop_port")
    res = RadarSlamSystem(LOOP_SEQ, loop_seq["root"], cfg, device="cpu").run(
        frame_source=_frames(loop_seq), metrics_path=str(tmp / "m.jsonl"),
        checkpoint_dir=str(tmp / "ck"), **kw)
    return dict(cfg=cfg, jres=jres, jinc=jinc, res=res, tmp=tmp)


def _close(a, b, tol_m, tol_rad):
    np.testing.assert_allclose(a[:, :2], b[:, :2], atol=tol_m, rtol=0)
    np.testing.assert_allclose(a[:, 2], b[:, 2], atol=tol_rad, rtol=0)


def test_optimize_map_on_the_jax_final_state(loop_runs):
    """The port's post-hoc back-end on the JAX driver's final state (carried
    across) against what the JAX driver's own pass computed from it."""
    d = loop_runs
    jres = d["jres"]
    state = slam_state_from_numpy(jax.device_get(jres.final_state), d["cfg"], "cpu")
    kf_pg, n_loops, pg_cost, kf_ba, lm_ba, ba_cost = RadarSlamSystem.optimize_map(
        _backend_only(d["cfg"]), state, ba=True)
    assert n_loops == jres.n_loop_closures >= 1
    _close(kf_pg, jres.kf_poses_optimized, PG_M, PG_RAD)
    assert pg_cost == pytest.approx(jres.posegraph_cost, rel=1e-4, abs=1e-6)
    _close(kf_ba, jres.kf_poses_ba, BA_M, BA_RAD)
    assert lm_ba.shape == jres.landmarks_ba.shape
    np.testing.assert_allclose(lm_ba, jres.landmarks_ba, atol=BA_M, rtol=0)
    assert ba_cost == pytest.approx(jres.ba_cost, rel=1e-3)


def _backend_only(cfg):
    """A RadarSlamSystem stand-in for `optimize_map`, which reads only cfg."""
    obj = RadarSlamSystem.__new__(RadarSlamSystem)
    obj.cfg = cfg
    return obj


def test_incremental_backend_on_the_jax_final_state(loop_runs):
    from radarslampy_tpu_torch.models.loopclosure import incremental_backend

    d = loop_runs
    state = slam_state_from_numpy(jax.device_get(d["jres"].final_state), d["cfg"], "cpu")
    st, n, cost, bs = incremental_backend(state, d["cfg"])
    jst, jn, jcost, jbs = d["jinc"]
    assert n == jn >= 1 and bs.prev_cursor == jbs.prev_cursor
    np.testing.assert_array_equal(bs.edges_ij, jbs.edges_ij)
    assert cost == pytest.approx(jcost, rel=1e-4)
    _close(st.pose[None].numpy(), np.asarray(jst.pose)[None], PG_M, PG_RAD)
    _close(st.kf_pose[None].numpy(), np.asarray(jst.kf_pose)[None], PG_M, PG_RAD)
    _close(st.map.poses.numpy(), np.asarray(jst.map.poses), PG_M, PG_RAD)
    # world features move with their keyframe: the pose bound plus the heading
    # bound over the longest lever arm
    lever = float(torch.linalg.vector_norm(state.map.feat_local, dim=-1).max())
    for a, b in ((st.feat_world, jst.feat_world), (st.map.feat_world, jst.map.feat_world)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PG_M + PG_RAD * lever, rtol=0)


def test_run_with_the_backend_fills_every_field(loop_runs, loop_seq):
    d = loop_runs
    res, jres = d["res"], d["jres"]
    assert res.frames == jres.frames == LOOP_N
    assert res.n_keyframes == jres.n_keyframes == LOOP_N
    assert res.n_online_loops >= 1 and jres.n_online_loops >= 1
    assert res.n_loop_closures >= 1 and jres.n_loop_closures >= 1
    M = res.n_keyframes
    for f in ("kf_poses_optimized", "kf_poses_ba"):
        x = getattr(res, f)
        assert x.shape == (M, 3) and np.isfinite(x).all(), f
    assert res.landmarks_ba.ndim == 2 and len(res.landmarks_ba) > 0
    assert np.isfinite([res.posegraph_cost, res.ba_cost]).all()
    recs = _records(d["tmp"] / "m.jsonl")
    assert [r["frame"] for r in recs if "online_loops_closed" in r] == [2 * LOOP_B]
    assert sum(r.get("online_loops_closed", 0) for r in recs) == res.n_online_loops
    # the final checkpoint holds the state the online passes re-anchored
    state, _ = checkpoint.load_state(str(d["tmp"] / "ck"), d["cfg"], "cpu")
    for a, b in zip(_leaves(state), _leaves(res.final_state)):
        assert torch.equal(a, b)
