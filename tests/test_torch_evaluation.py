"""The port's evaluation harness (`radarslampy_tpu_torch/evaluation.py`) held
against the JAX package's on the CPU.

No Oxford GT exists here: trajectories are synthetic (a circle of 40 frames
a turn with 2.2 m chords, its speed ramped up over the first frames, see
tests/test_torch_render_device.py), and the CLI reads the GT csv that
`sim/oxford_files.write_sequence` writes.  Config: the small grid of
tests/conftest.py (512 px at 8 bins/px, 256 candidates, ANMS 100, K 128)
with 128 keyframes and the 8-step LM of tests/test_system.py.  Bounds: the
host pieces (RPE, GT subsequence, keyframe association) exact; the two
host-render paths, each package carrying its own state over the same scans,
within `LM_CASES` of tests/test_torch_sequence.py for 8 LM steps (measured
here: 6.9e-3 m / 2.4e-4 rad per frame, 2.5e-3 m / 1.4e-5 rad chunked), the
keyframe and retrack flags of every frame equal, and the inlier counts within
2 (measured: equal chunked; frame by frame one frame differs by one, as the
two LMs' centimetre-level gap moves a tracked feature across the peeling
threshold); `_run_ba` on the JAX map carried across within 1e-3 m of
keyframe ATE (measured 3.9e-7 m), with equal counts.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from radarslampy_tpu import evaluation as jev
from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import frontend as JF
from radarslampy_tpu.models import loopclosure as jlc
from radarslampy_tpu.utils import checkpoint as jckpt
from radarslampy_tpu_torch import evaluation as ev
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import slam_state_from_numpy
from radarslampy_tpu_torch.models import frontend as TF
from radarslampy_tpu_torch.models.loopclosure import trim_map_state
from radarslampy_tpu_torch.sim import oxford_files
from radarslampy_tpu_torch.utils import checkpoint
from tests.test_torch_render_device import ramp_circle
from tests.test_torch_sequence import LM_CASES

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

KW = dict(cart_size=512, cart_downsample=8, n_candidates=256, anms_top_k=100, k_max=128,
          max_keyframes=128, mds_iterations=8)
N = 13
SEED = 3
ATOL_M, ATOL_RAD = next((m, r) for it, m, r in LM_CASES if it == KW["mds_iterations"])
# the keys of the JAX CLI's JSON artifact (radarslampy_tpu/evaluation.py, `_artifact`)
JAX_ARTIFACT_KEYS = [
    "gt_csv", "start", "count", "path_m", "world", "seed", "noise", "cart_size",
    "max_keyframes", "loop_method", "backend_every", "chunk_frames", "renderer", "platform",
    "frames", "fps", "n_keyframes", "ate_odometry_m", "n_online_loops", "n_loop_closures",
    "ate_keyframes_before_m", "ate_keyframes_after_m", "ate_keyframes_after_ba_m",
    "n_ba_landmarks", "n_ba_observations", "loop_edge_err_median_m", "loop_edge_err_p90_m",
    "n_loop_edges_bad", "mean_inliers", "frac_fit_ok", "n_retracks", "backend_error",
    "rpe_trans_pct", "rpe_rot_deg_100m", "heading_rmse_deg", "quantize", "reference_ate_m"]


def _walk(n, seed):
    rng = np.random.default_rng(seed)
    th = np.cumsum(rng.normal(0, 0.05, n))
    th[0] = 0.0
    xy = np.concatenate([[[0.0, 0.0]], np.cumsum(
        np.stack([2.0 * np.cos(th[1:]), 2.0 * np.sin(th[1:])], 1), axis=0)])
    return np.concatenate([xy, th[:, None]], 1)


@pytest.mark.parametrize("n,seg_m,stride", [(300, 100.0, 10), (300, 40.0, 3), (30, 100.0, 10)])
def test_compute_rpe_equals_jax(n, seg_m, stride):
    gt = _walk(n, 1)
    est = gt + np.random.default_rng(2).normal(0, [0.3, 0.3, 0.01], gt.shape)
    assert ev.compute_rpe(gt, est, seg_m, stride) == jev.compute_rpe(gt, est, seg_m, stride)
    if n * 2.0 < seg_m:
        assert ev.compute_rpe(gt, est, seg_m, stride) == (None, None)


def test_gt_subsequence_equals_jax(tmp_path):
    poses = _walk(60, 4)
    poses[:, 2] = (poses[:, 2] + np.pi) % (2 * np.pi) - np.pi
    oxford_files.write_sequence(str(tmp_path), "seq", poses, SlamConfig(**KW))
    csv = str(tmp_path / "seq" / "gt" / "radar_odometry.csv")
    for start, count, stride in ((0, 60, 1), (7, 20, 2), (11, 5, 3)):
        a = ev.gt_subsequence(csv, start, count, stride)
        np.testing.assert_array_equal(a, jev.gt_subsequence(csv, start, count, stride))
        assert a.shape == (count, 3)
        np.testing.assert_allclose(a[0], 0.0, atol=1e-12)
    np.testing.assert_allclose(ev.gt_subsequence(csv, 0, 60), poses, atol=1e-9)


def test_associate_equals_jax():
    gt = _walk(40, 5)
    est = gt + 0.1
    kf = est[::3] + 0.05
    fids = np.arange(0, 40, 3)
    for ids in (fids, None):
        np.testing.assert_array_equal(ev._associate(kf, gt, est, frame_ids=ids),
                                      jev._associate(kf, gt, est, frame_ids=ids))
    np.testing.assert_array_equal(ev._associate(kf, gt, est, frame_ids=fids), gt[fids])


def _spy_flags(monkeypatch):
    """Record (is_keyframe, did_retrack, n_inliers) of every step of both
    packages, in order: the port's through its step, JAX's through an ordered
    callback traced into its jitted step."""
    port, jax_flags = [], []
    port_step, jax_step = TF.slam_step, JF.slam_step

    def port_spy(s, p, m, c):
        s2, out = port_step(s, p, m, c)
        port.append((bool(out.is_keyframe), bool(out.did_retrack), int(out.n_inliers)))
        return s2, out

    def jax_spy(s, p, m, c):
        s2, out = jax_step(s, p, m, c)
        jax.debug.callback(lambda kf, rt, n: jax_flags.append((bool(kf), bool(rt), int(n))),
                           out.is_keyframe, out.did_retrack, out.n_inliers, ordered=True)
        return s2, out

    monkeypatch.setattr(TF, "slam_step", port_spy)
    monkeypatch.setattr(JF, "slam_step", jax_spy)
    return port, jax_flags


@pytest.fixture(scope="module")
def host_paths():
    """Both packages over the same host-rendered scans: frame by frame
    (float scans) and in chunks of 8 (u8 scans, a tail of 4 frame by frame)."""
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    poses = ramp_circle(N)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        flags = _spy_flags(mp)
        for chunk in (0, 8):
            kw = dict(seed=SEED, chunk_frames=chunk, device_render=False, return_state=True)
            j = jev.evaluate_sequence(poses, jcfg, **kw)
            jax.effects_barrier()
            p = ev.evaluate_sequence(poses, cfg, device="cpu", **kw)
            out[chunk] = (p, j, list(flags[0]), list(flags[1]))
            flags[0].clear()
            flags[1].clear()
    return poses, out


@pytest.mark.parametrize("chunk", [0, 8])
def test_host_render_paths_match_jax(host_paths, chunk):
    poses, out = host_paths
    p, j, pflags, jflags = out[chunk]
    assert len(pflags) == len(jflags) == N - 1
    assert [f[:2] for f in pflags] == [f[:2] for f in jflags]
    assert max(abs(a[2] - b[2]) for a, b in zip(pflags, jflags)) <= 2
    assert p.frames == j.frames == N and p.n_keyframes == j.n_keyframes
    np.testing.assert_array_equal(p.final_state.map.frame_ids.numpy(),
                                  np.asarray(j.final_state.map.frame_ids))
    np.testing.assert_allclose(p.est_frames[:, :2], j.est_frames[:, :2], atol=ATOL_M, rtol=0)
    np.testing.assert_allclose(p.est_frames[:, 2], j.est_frames[:, 2], atol=ATOL_RAD, rtol=0)
    assert p.ate_odometry < 1.0 and j.ate_odometry < 1.0
    assert p.mean_inliers is None and j.mean_inliers is None   # health: device path only


def test_run_ba_on_the_jax_map(host_paths):
    """`_run_ba` on identical maps: the JAX per-frame run's final map,
    trimmed, and the port's copy of it; poses perturbed as a pose graph
    would move them, so BA has work to do."""
    poses, out = host_paths
    j = out[0][1]
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    jm = jlc.trim_map_state(jax.device_get(j.final_state.map))
    M = int(jm.cursor)
    i = np.arange(M)[:, None]
    opt = (np.asarray(jm.poses)[:M]
           + np.concatenate([0.05 * np.sin(i), 0.05 * np.cos(i), 2e-3 * np.sin(i)], 1)
           ).astype(np.float32)
    gt_kf = jev._associate(opt, poses, j.est_frames, frame_ids=np.asarray(jm.frame_ids)[:M])
    ja = jev._run_ba(jm, opt, gt_kf, M, jcfg)
    m = trim_map_state(slam_state_from_numpy(jax.device_get(j.final_state), cfg, "cpu").map)
    pa = ev._run_ba(m, opt, gt_kf, M, cfg)
    assert pa[1:] == ja[1:] and pa[1] > 0 and pa[2] > pa[1]
    assert abs(pa[0] - ja[0]) <= 1e-3, (pa, ja)


def test_port_eval_checkpoint_loads_in_the_jax_package(host_paths, tmp_path):
    """A checkpoint of the port's device-render path has the JAX harness's
    layout: the JAX `load_state` / `load_meta` read it, leaf for leaf, and
    `eval_results.npz` holds JAX's keys."""
    poses, out = host_paths
    ck = str(tmp_path / "ck")
    ev.evaluate_sequence(poses[:5], SlamConfig(**KW), seed=SEED, chunk_frames=2, ckpt_dir=ck,
                         ckpt_every=2, backend_every=2, device="cpu")
    meta = jckpt.load_meta(ck)
    assert meta == checkpoint.load_meta(ck)
    assert {k: meta[k] for k in ("next_t", "count", "seed", "chunk_frames", "renderer",
                                 "quantize", "n_online_loops", "backend_prev_cursor")} == dict(
        next_t=3, count=5, seed=SEED, chunk_frames=2, renderer="max", quantize=True,
        n_online_loops=0, backend_prev_cursor=3)
    jstate, _ = jckpt.load_state(ck, jax.device_get(out[0][1].final_state))
    pstate, _ = checkpoint.load_state(ck, SlamConfig(**KW), "cpu")
    jleaves = jax.tree_util.tree_leaves(jstate)
    pleaves = list(pstate[:-2]) + list(pstate.map) + [pstate.frame_idx]
    assert len(jleaves) == len(pleaves) == 22
    for a, b in zip(jleaves, pleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with np.load(os.path.join(ck, "eval_results.npz")) as rz:
        assert sorted(rz.files) == ["blocks", "edges_ij", "edges_meas", "valid"]
        assert rz["blocks"].shape == (1, 2, 6) and list(rz["valid"]) == [2]
        assert rz["edges_ij"].shape == (0, 2) and rz["edges_meas"].shape == (0, 3)


# ---- the back-end stage ----
# 49 frames: the circle closes after 40, so keyframes 42-48 revisit 0-6 with
# an index gap over min_index_gap (20).  Online passes every 24 frames (after
# frames 33 and 49 at chunks of 16), 3 pose-graph LM iterations (the online
# pass pads the map to 1024 rows: a dense 3072 x 3072 solve per iteration).
LOOP_N, LOOP_EVERY = 49, 24


def test_backend_fills_every_field():
    cfg = SlamConfig(**dict(KW, pg_iterations=3))
    calls = []

    def partial_write(res):
        calls.append((res.ate_keyframes_before, res.ate_keyframes_after))

    res = ev.evaluate_sequence(ramp_circle(LOOP_N), cfg, seed=SEED, chunk_frames=16,
                               run_ba=True, backend_every=LOOP_EVERY,
                               partial_write=partial_write, device="cpu")
    assert res.backend_error is None
    assert res.n_online_loops >= 1 and res.n_loop_closures >= res.n_online_loops
    M = res.n_keyframes
    assert res.gt_keyframes.shape == (M, 3)
    for f in ("ate_keyframes_before", "ate_keyframes_after", "ate_keyframes_after_ba",
              "loop_edge_err_median", "loop_edge_err_p90", "mean_inliers", "frac_fit_ok",
              "rpe_trans_pct", "rpe_rot_deg_100m", "heading_rmse_deg"):
        assert np.isfinite(getattr(res, f)), f
    assert res.loop_edge_err_median <= res.loop_edge_err_p90
    assert 0 <= res.n_loop_edges_bad <= res.n_loop_closures
    assert res.n_ba_observations > res.n_ba_landmarks > 0
    # partial_write: before the back-end (odometry only), after the pose graph
    assert calls == [(None, None), (res.ate_keyframes_before, res.ate_keyframes_after)]


def test_entry_points_raise_without_cuda(tmp_path):
    """No CPU fallback: without `device="cpu"` (CLI: `--cpu`) the harness
    asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ev.evaluate_sequence(ramp_circle(3), SlamConfig(**KW))
    oxford_files.write_sequence(str(tmp_path), "seq", ramp_circle(3), SlamConfig(**KW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ev.main(["--gt-csv", str(tmp_path / "seq" / "gt" / "radar_odometry.csv"),
                 "--count", "3"])


def test_cli_writes_the_jax_artifact(tmp_path, capsys):
    """`python -m radarslampy_tpu_torch.evaluation ... --cpu` on a written
    GT csv: the JAX CLI's printed lines and every key of its artifact;
    `--matmul-precision highest` runs (the JAX CLI raises on it) and the
    precision is restored after the run."""
    poses = ramp_circle(9)
    oxford_files.write_sequence(str(tmp_path), "seq", poses, SlamConfig(**KW))
    csv = str(tmp_path / "seq" / "gt" / "radar_odometry.csv")
    out = str(tmp_path / "eval.json")
    argv = ["--gt-csv", csv, "--count", "9", "--cart-size", "256", "--progress-every", "0",
            "--chunk-frames", "4", "--backend", "--ba", "--backend-every", "4",
            "--matmul-precision", "highest", "--out", out]
    before = torch.get_float32_matmul_precision()
    res = ev.main(argv + ["--cpu"])
    assert torch.get_float32_matmul_precision() == before
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("eval: 9 frames,")
    assert [ln.split(" ")[0] for ln in lines[1:]] == ["odometry", "health:", "loop", "BA"]
    with open(out) as f:
        art = json.load(f)
    assert [k for k in art if k in JAX_ARTIFACT_KEYS] == JAX_ARTIFACT_KEYS
    assert set(art) - set(JAX_ARTIFACT_KEYS) == {"device_name"}
    assert art["platform"] == "cpu" and art["device_name"] is None
    assert art["frames"] == res.frames == 9 and art["chunk_frames"] == 4
    assert art["n_ba_landmarks"] == res.n_ba_landmarks > 0
    assert art["backend_error"] is None
    with pytest.raises(UnboundLocalError):
        jev.main(argv + ["--cpu"])
