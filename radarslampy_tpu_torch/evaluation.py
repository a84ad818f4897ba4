"""Long-sequence evaluation harness: synthetic scans along a GT trajectory.

Counterpart of `radarslampy_tpu/evaluation.py`.  Scans are rendered from a
landmark world (the corridor world by default) along a ground-truth
trajectory, run through the odometry step, and scored against that
trajectory: odometry ATE, RPE per 100 m, heading RMSE; optionally the
back-end (loop closure, pose graph, BA) online during the run and post hoc
after it, scored by keyframe ATE before and after each stage and by the
loop edges' error against GT.

    python -m radarslampy_tpu_torch.evaluation --gt-csv <csv> --count 200 \\
        --chunk-frames 16 --backend --ba --backend-every 32 --out eval.json

Three paths, as in the JAX harness: scans rendered on the device in chunks
(`chunk_frames > 0`, the default `device_render`), rendered on the host in
chunks through `slam_step_chunk`, or rendered on the host as float scans
frame by frame (`chunk_frames=0`).  Everything runs on `device` ("cuda" by
default; "cpu" only when asked).  Every step is a replay of the step's CUDA
graph (`frontend.StepGraph`, as the JAX harness jits its step and chunk); on
the CPU the eager step.

The JAX harness's workarounds for the TPU client change nothing here and are
kept only so that calls and artifacts match: `consolidate_every` (device-side
stacking of result blocks, against the client's live-handle limit) and
`fusion_barrier` (an XLA optimisation barrier between renderer and step) are
accepted and have no effect; `sync_every` sets how often the device-render
loop calls `torch.cuda.synchronize`.  Per-frame results stay on the device as
[F, 6] blocks and are fetched once at the end and at checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.io import oxford
from radarslampy_tpu_torch.models import frontend
from radarslampy_tpu_torch.models.ba import build_ba_problem, optimize_ba, reseed_map
from radarslampy_tpu_torch.models.loopclosure import (BackendState, close_loops,
                                                      graph_with_loop_edges,
                                                      incremental_backend, scan_new_loops,
                                                      trim_map_state)
from radarslampy_tpu_torch.models.posegraph import optimize_pose_graph
from radarslampy_tpu_torch.models.trajectory import compute_rmse
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.sim.render_device import quantize_u8, render_polar_scan_device
from radarslampy_tpu_torch.utils.checkpoint import load_meta, load_state, save_state


@dataclasses.dataclass
class EvalResult:
    frames: int
    fps: float
    ate_odometry: float
    n_keyframes: int
    n_loop_closures: int = 0
    n_online_loops: int = 0
    ate_keyframes_before: Optional[float] = None
    ate_keyframes_after: Optional[float] = None
    ate_keyframes_after_ba: Optional[float] = None
    n_ba_landmarks: int = 0
    n_ba_observations: int = 0
    # per-frame health aggregates (device-render path)
    mean_inliers: Optional[float] = None
    frac_fit_ok: Optional[float] = None
    n_retracks: int = 0
    final_state: object = None       # SlamState when return_state=True
    est_frames: Optional[np.ndarray] = None
    gt_keyframes: Optional[np.ndarray] = None
    # loop-edge measurement error against GT (frame-indexed): tells bad
    # edges from a bad solver when the back-end underperforms
    loop_edge_err_median: Optional[float] = None
    loop_edge_err_p90: Optional[float] = None
    n_loop_edges_bad: int = 0        # edges whose translation error > 1 m
    backend_error: Optional[str] = None  # pose-graph / BA exception, salvaged
    # drift rates: RPE over ~100 m segments and the absolute heading error
    rpe_trans_pct: Optional[float] = None      # mean rel. transl. err, % of 100 m
    rpe_rot_deg_100m: Optional[float] = None   # mean rel. rot. err, deg / 100 m
    heading_rmse_deg: Optional[float] = None   # absolute heading error RMSE


def compute_rpe(poses_gt: np.ndarray, est: np.ndarray, seg_m: float = 100.0,
                stride: int = 10):
    """KITTI-style relative pose error over ~`seg_m`-long GT path segments
    -> (translation error in % of segment length, rotation error in deg /
    100 m), averaged over segment starts every `stride` frames; (None, None)
    when the path is shorter than one segment."""
    d = np.linalg.norm(np.diff(poses_gt[:, :2], axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(d)])
    errs_t, errs_r = [], []
    for i in range(0, len(poses_gt) - 1, stride):
        j = int(np.searchsorted(cum, cum[i] + seg_m))
        if j >= len(poses_gt):
            break
        seg = cum[j] - cum[i]
        if seg <= 1.0:
            continue

        def rel(p, i=i, j=j):
            dd = p[j, :2] - p[i, :2]
            c, s = np.cos(p[i, 2]), np.sin(p[i, 2])
            return np.array(
                [c * dd[0] + s * dd[1], -s * dd[0] + c * dd[1],
                 (p[j, 2] - p[i, 2] + np.pi) % (2 * np.pi) - np.pi]
            )

        rg, re = rel(poses_gt), rel(est)
        errs_t.append(np.linalg.norm(re[:2] - rg[:2]) / seg)
        dth = (re[2] - rg[2] + np.pi) % (2 * np.pi) - np.pi
        errs_r.append(abs(dth) / seg * 100.0)
    if not errs_t:
        return None, None
    return (float(np.mean(errs_t) * 100.0),
            float(np.degrees(np.mean(errs_r))))


def gt_subsequence(gt_csv: str, start: int, count: int, stride: int = 1):
    """[count, 3] poses from a GT odometry csv, re-anchored to the origin."""
    _, poses, _ = oxford.load_gt_trajectory(gt_csv)
    seg = poses[start : start + count * stride : stride].copy()
    # re-anchor: first pose at origin, heading 0
    x0, y0, th0 = seg[0]
    c, s = np.cos(-th0), np.sin(-th0)
    xy = seg[:, :2] - (x0, y0)
    seg[:, 0] = c * xy[:, 0] - s * xy[:, 1]
    seg[:, 1] = s * xy[:, 0] + c * xy[:, 1]
    seg[:, 2] = (seg[:, 2] - th0 + np.pi) % (2 * np.pi) - np.pi
    return seg


def frame_seed(seed: int, fid: int) -> int:
    """The seed of frame `fid`'s noise generator: a function of the run's
    seed and the absolute frame index only, so a sequence renders the same
    however it is chunked or resumed."""
    return int(np.random.SeedSequence([seed, fid]).generate_state(1, np.uint64)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_eval_chunk(cfg: SlamConfig, noise: float, k_vis: int = 512,
                    renderer: str = "max", quantize: bool = True,
                    fusion_barrier: bool = True):
    """F frames per call: render each scan on the device, quantise it to u8
    (unless `quantize=False`, the float A/B) and step the state.

    The returned function takes (state, poses [F, 3], velocities [F, 3],
    frame ids [F], valid [F] (host bools), seed, world points [N, 2], world
    reflectivities [N], maps) and returns (state, packed [F, 6] float32 on
    the device): per frame [x, y, theta, n_inliers, fit_ok, did_retrack].
    Padded tail frames (`valid[i]` False) neither render nor step; their rows
    echo the state's pose with zeros in the last three columns.  Each frame's
    noise generator is seeded by `frame_seed(seed, frame id)`.  The step is
    the returned function's own StepGraph (one for the `maps` of its latest
    call): loaded with the state, replayed a frame, and the state returned
    is a copy of the graph's.
    `fusion_barrier` has no effect (the renderer and the step are separate
    calls)."""
    del fusion_barrier
    graph = None

    def chunk_fn(state, poses_f, vels_f, frame_ids, valid, seed, wp, wr, maps):
        nonlocal graph
        dev = state.pose.device
        f32 = state.pose.dtype
        poses_f = torch.as_tensor(poses_f, dtype=f32, device=dev)
        vels_f = torch.as_tensor(vels_f, dtype=f32, device=dev)
        if graph is None or graph.maps is not maps:
            graph = frontend.StepGraph(maps, cfg)
        graph.load(state)
        rows = []
        for i, ok in enumerate(np.asarray(valid, bool)):
            if not ok:
                rows.append(torch.cat([graph.state.pose,
                                       torch.zeros(3, dtype=f32, device=dev)]))
                continue
            gen = torch.Generator(device=dev)
            gen.manual_seed(frame_seed(seed, int(frame_ids[i])))
            scan = render_polar_scan_device(wp, wr, poses_f[i], vels_f[i], gen, cfg,
                                            noise=noise, k_vis=k_vis, mode=renderer)
            row = graph.step(quantize_u8(scan) if quantize else scan)
            # [x, y, theta, n_inliers, fit_ok, did_retrack] of the packed row
            rows.append(torch.cat([row[0:3], row[4:6], row[7:8]]))
        return graph.snapshot(), torch.stack(rows)

    return chunk_fn


def _body_velocities(poses_gt, period):
    """Per-frame body-frame velocities [T, 3] (frame 0 at rest), the motion
    each scan is distorted by."""
    T = len(poses_gt)
    vels = np.zeros((T, 3), np.float32)
    if T > 1:
        dp = np.diff(poses_gt, axis=0)
        cth = np.cos(poses_gt[1:, 2])
        sth = np.sin(poses_gt[1:, 2])
        vels[1:, 0] = (cth * dp[:, 0] + sth * dp[:, 1]) / period
        vels[1:, 1] = (-sth * dp[:, 0] + cth * dp[:, 1]) / period
        vels[1:, 2] = dp[:, 2] / period
    return vels


def evaluate_sequence(
    poses_gt: np.ndarray,
    cfg: SlamConfig,
    seed: int = 0,
    n_landmarks_per_km2: float = 400.0,
    run_backend: bool = False,
    run_ba: bool = False,
    noise: float = 0.02,
    progress_every: int = 0,
    return_state: bool = False,
    world: str = "corridor",
    landmarks_per_scan: float = 80.0,
    backend_every: int = 0,
    chunk_frames: int = 0,
    device_render: bool = True,
    consolidate_every: int = 16,
    renderer: str = "max",
    partial_write=None,
    sync_every: int = 1,
    quantize: bool = True,
    fusion_barrier: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 2048,
    resume: bool = False,
    device="cuda",
):
    """Render scans along `poses_gt`, run SLAM on `device`, report ATE (and
    the back-end's keyframe ATEs) as an `EvalResult`.

    `backend_every`: frames between online passes (`incremental_backend`)
    fed back into the running state (0 = off); with `run_backend` the final
    post-hoc pass still runs, over the accumulated online edges plus the
    keyframes the last pass has not seen, or (no online pass) `close_loops`
    with a radius that grows with the path.  `run_ba` implies `run_backend`.

    `chunk_frames`: > 0 steps F frames per call.  With `device_render` the
    scans are rendered on the device (`make_eval_chunk`), a short tail padded
    with masked frames; without it they are rendered on the host, quantised
    to u8 and stepped through `slam_step_chunk`, the tail frame by frame.
    0: host-rendered float scans, frame by frame.  Frame 0 is always rendered
    on the host, as a float scan.

    `ckpt_dir` / `ckpt_every` / `resume` (device-render path): every
    `ckpt_every` frames save the state, the fetched result blocks, the online
    back-end's edges and the cursors; `resume` continues from such a
    checkpoint (a fresh start if there is none) and refuses one written by
    another configuration (count, seed, chunk_frames, renderer, quantize).

    `partial_write(result)` is called before the back-end and again after
    the pose graph, so a failure there keeps what came before; a pose-graph
    or BA exception is recorded in `backend_error`.
    """
    del consolidate_every
    dev = resolve_device(device)
    # run_ba implies the back-end (BA consumes the trimmed map and the pose
    # graph's poses)
    run_backend = run_backend or run_ba

    rng = np.random.default_rng(seed)
    maps = frontend.build_frame_maps(cfg, dev)

    if world == "corridor":
        world_pts, world_refl = fd.make_world_corridor(
            rng, poses_gt, cfg.max_range_clip_m, per_scan=landmarks_per_scan
        )
    else:
        span = poses_gt[:, :2]
        extent = float(np.abs(span).max() + cfg.max_range_clip_m)
        area_km2 = (2 * extent / 1000.0) ** 2
        n_landmarks = max(800, int(area_km2 * n_landmarks_per_km2))
        world_pts, world_refl = fd.make_world(rng, n_landmarks, extent)

    period = cfg.scan_period_s

    def render(t):
        if t > 0:
            dp = poses_gt[t] - poses_gt[t - 1]
            c, s = np.cos(poses_gt[t][2]), np.sin(poses_gt[t][2])
            vel = np.array(
                [c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1], dp[2]]
            ) / period
        else:
            vel = np.zeros(3)
        return fd.render_polar_scan(
            world_pts, world_refl, poses_gt[t], cfg, velocity=vel, rng=rng,
            noise=noise, mode=renderer,
        )

    graph = frontend.StepGraph(maps, cfg)   # this run's step

    def online(state, backend_state):
        return incremental_backend(state, cfg, backend_state=backend_state)

    T = len(poses_gt)
    state = frontend.init_state(render(0), np.zeros(3), maps, cfg)
    device_poses = []
    n_online_loops = 0
    backend_state = None
    health = None
    fps_base = 1          # first frame index processed by this call (resume)
    _sync(dev)
    t0 = time.perf_counter()
    if chunk_frames > 0 and device_render:
        vels = _body_velocities(poses_gt, period)
        wp = torch.as_tensor(world_pts, dtype=torch.float32, device=dev)
        wr = torch.as_tensor(world_refl, dtype=torch.float32, device=dev)
        chunk = make_eval_chunk(cfg, noise=noise, renderer=renderer, quantize=quantize)
        chunk_packed = []  # [F, 6] device blocks, fetched in bulk
        chunk_valid = []
        # blocks already on the host (checkpoint drains, or loaded on
        # resume), strictly before those still on the device
        host_flat: list = []
        host_valid: list = []
        F = chunk_frames
        t = 1

        def _drain_to_host():
            nonlocal chunk_packed
            if chunk_packed:
                host_flat.extend(torch.stack(chunk_packed).cpu().numpy())
            host_valid.extend(chunk_valid)
            chunk_valid.clear()
            chunk_packed = []

        def _write_ckpt(next_t):
            _drain_to_host()
            save_state(ckpt_dir, state, meta={
                "next_t": int(next_t),
                "n_online_loops": int(n_online_loops),
                "seed": int(seed),
                "count": int(T),
                "chunk_frames": int(F),
                "renderer": renderer,
                "quantize": bool(quantize),
                "backend_prev_cursor": (int(backend_state.prev_cursor)
                                        if backend_state is not None else 0),
            })
            np.savez(
                os.path.join(ckpt_dir, "eval_results.npz"),
                blocks=(np.stack(host_flat) if host_flat
                        else np.zeros((0, F, 6), np.float32)),
                valid=np.asarray(host_valid, np.int64),
                edges_ij=(backend_state.edges_ij if backend_state is not None
                          else np.zeros((0, 2), np.int32)),
                edges_meas=(backend_state.edges_meas if backend_state is not None
                            else np.zeros((0, 3), np.float32)),
            )

        if resume and ckpt_dir is not None and \
                os.path.exists(os.path.join(ckpt_dir, "treedef.json")):
            meta = load_meta(ckpt_dir)
            if (meta.get("count") != T or meta.get("seed") != seed
                    or meta.get("chunk_frames") != F
                    or meta.get("renderer") != renderer
                    or meta.get("quantize", True) != quantize):
                raise ValueError(
                    f"checkpoint at {ckpt_dir} was written by a different "
                    f"run configuration ({meta}) — refusing to resume")
            state, _ = load_state(ckpt_dir, cfg, dev)
            with np.load(os.path.join(ckpt_dir, "eval_results.npz")) as rz:
                host_flat = list(rz["blocks"])
                host_valid = list(rz["valid"])
                if backend_every:
                    backend_state = BackendState(
                        prev_cursor=int(meta["backend_prev_cursor"]),
                        edges_ij=rz["edges_ij"],
                        edges_meas=rz["edges_meas"],
                    )
            t = int(meta["next_t"])
            n_online_loops = int(meta["n_online_loops"])
            if progress_every:
                print(f"  resumed from {ckpt_dir} at frame {t}/{T} "
                      f"({len(host_flat)} result blocks, "
                      f"{n_online_loops} online loops)", flush=True)

        fps_base = t
        last_ckpt_t = t
        while t < T:
            n = min(F, T - t)
            pv = np.zeros((F, 3), np.float32)
            vv = np.zeros((F, 3), np.float32)
            valid = np.zeros(F, bool)
            pv[:n] = poses_gt[t : t + n]
            vv[:n] = vels[t : t + n]
            valid[:n] = True
            fid = np.minimum(np.arange(t, t + F), T - 1).astype(np.int32)
            tc0 = time.perf_counter()
            state, packed = chunk(state, pv, vv, fid, valid, seed, wp, wr, maps)
            n_chunk = len(chunk_valid)
            if sync_every and (n_chunk % sync_every == 0):
                _sync(dev)
            elif not sync_every and n_chunk % 64 == 63:
                _sync(dev)
            tc1 = time.perf_counter()
            chunk_packed.append(packed)
            chunk_valid.append(n)
            t += n
            if backend_every and (t - 1) % backend_every < n:
                state, nl, _, backend_state = online(state, backend_state)
                n_online_loops += nl
            if progress_every and (t // progress_every) != ((t - n) // progress_every):
                print(f"  frame {t}/{T}  "
                      f"({(tc1 - tc0) / n * 1e3:.1f} ms/frame device wall)",
                      flush=True)
            if ckpt_dir is not None and (t - last_ckpt_t) >= ckpt_every and t < T:
                _write_ckpt(t)
                last_ckpt_t = t
                if progress_every:
                    print(f"  checkpoint written at frame {t} -> {ckpt_dir}",
                          flush=True)
        # one bulk fetch of the blocks still on the device; host blocks
        # (checkpoint drains, resume) come first in frame order
        stats_inl, stats_ok, stats_rt = [], [], []
        all_valid = host_valid + chunk_valid
        flat = list(host_flat)
        if chunk_packed:
            flat.extend(torch.stack(chunk_packed).cpu().numpy())
        for block, n in zip(flat, all_valid):
            block = np.asarray(block)[:n]
            device_poses.extend(block[:, :3])
            stats_inl.extend(block[:, 3])
            stats_ok.extend(block[:, 4])
            stats_rt.extend(block[:, 5])
        if stats_inl:  # T == 1: no steps, no health
            health = (float(np.mean(stats_inl)), float(np.mean(stats_ok)),
                      int(np.sum(stats_rt)))
    elif chunk_frames > 0:
        def to_u8(x):
            # u8 quantisation: the PNG path's u8/255 decode
            return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)

        t = 1
        while t < T:
            F = min(chunk_frames, T - t)
            if F == chunk_frames:
                block = np.stack([to_u8(render(t + k)) for k in range(F)])
                state, outs = frontend.slam_step_chunk(
                    state, torch.as_tensor(block, device=dev), maps, cfg, graph)
                device_poses.extend(outs.pose[:F])
            else:
                # tail shorter than a chunk: frame by frame
                graph.load(state)
                for k in range(F):
                    device_poses.append(graph.step(to_u8(render(t + k)))[0:3].clone())
                state = graph.snapshot()
            t += F
            if backend_every and (t - 1) % backend_every < F:
                state, nl, _, backend_state = online(state, backend_state)
                n_online_loops += nl
            if progress_every and (t // progress_every) != ((t - F) // progress_every):
                print(f"  frame {t}/{T}", flush=True)
    else:
        graph.load(state)
        for t in range(1, T):
            device_poses.append(graph.step(render(t))[0:3].clone())
            if backend_every and t % backend_every == 0:
                state, nl, _, backend_state = online(graph.snapshot(), backend_state)
                graph.load(state)
                n_online_loops += nl
                if progress_every and nl:
                    print(f"  frame {t}: online backend closed {nl} loops",
                          flush=True)
            if progress_every and t % progress_every == 0:
                print(f"  frame {t}/{T}", flush=True)
        state = graph.snapshot()
    _sync(dev)
    fps = max(T - fps_base, 1) / (time.perf_counter() - t0)

    if device_poses and isinstance(device_poses[0], torch.Tensor):
        est = torch.stack(device_poses).cpu().numpy()
    else:
        est = np.asarray(device_poses, np.float32).reshape(-1, 3)
    est = np.vstack([poses_gt[0][None], est])
    ate = compute_rmse(poses_gt, est)
    rpe_t, rpe_r = compute_rpe(poses_gt, est)
    dth_abs = (est[:, 2] - poses_gt[:, 2] + np.pi) % (2 * np.pi) - np.pi
    heading_rmse = float(np.degrees(np.sqrt(np.mean(dth_abs ** 2))))

    res = EvalResult(
        frames=T,
        fps=fps,
        ate_odometry=ate,
        n_keyframes=int(state.map.cursor),
        n_online_loops=n_online_loops,
        rpe_trans_pct=rpe_t,
        rpe_rot_deg_100m=rpe_r,
        heading_rmse_deg=heading_rmse,
    )
    if health is not None:
        res.mean_inliers, res.frac_fit_ok, res.n_retracks = health
    if return_state:
        res.final_state = state
        res.est_frames = est

    # flush the odometry results before the back-end, so a failure there
    # keeps the run
    if partial_write is not None:
        partial_write(res)
    if run_backend:
        _posthoc_backend(res, state, backend_state, poses_gt, est, cfg, run_ba,
                         partial_write, progress_every)
    return res


def _posthoc_backend(res: EvalResult, state, backend_state, poses_gt, est,
                     cfg: SlamConfig, run_ba: bool, partial_write, progress_every):
    """The final back-end pass over the run's map, filling `res`'s loop,
    keyframe-ATE, loop-edge-error, BA and `backend_error` fields."""
    if progress_every:
        print("  backend: loop closure...", flush=True)
    m = trim_map_state(state.map)
    if backend_state is not None:
        # the online edges were ICP-verified while drift was bounded; scan
        # only the keyframes the last online pass has not seen, then build
        # the graph from the accumulated edge set
        tail_ij, tail_rel = scan_new_loops(m, cfg, backend_state.prev_cursor)
        # dedup the tail against the accumulated edges, as
        # incremental_backend does: a duplicated (i, j) would double that
        # edge's weight
        seen_ij = set(map(tuple, backend_state.edges_ij.tolist()))
        fresh = np.array([tuple(e) not in seen_ij for e in tail_ij.tolist()], bool)
        acc_ij = np.concatenate([backend_state.edges_ij, tail_ij[fresh]])
        acc_rel = np.concatenate([backend_state.edges_meas, tail_rel[fresh]])
        graph = graph_with_loop_edges(m, acc_ij, acc_rel)
        res.n_loop_closures = len(acc_ij)
    else:
        # post hoc only, under the run's full drift: the pose-proximity gate
        # grows with the path length, capped so the search stays selective
        path_m = float(np.sum(np.linalg.norm(np.diff(poses_gt[:, :2], axis=0), axis=1)))
        graph, matches = close_loops(m, cfg, radius_m=min(60.0, 10.0 + 0.005 * path_m))
        res.n_loop_closures = int(matches.ok.sum())
    # accepted loop edges: every graph builder appends them after the M
    # odometry-chain slots
    E0 = m.poses.shape[0]
    lsel = graph.edge_mask[E0:].cpu().numpy()
    edges_ij = graph.edges_ij[E0:].cpu().numpy()[lsel]
    edges_rel = graph.edges_meas[E0:].cpu().numpy()[lsel]
    if progress_every:
        print(f"  backend: {res.n_loop_closures} loops; pose graph...", flush=True)
    M = int(m.cursor)
    kf_poses_before = m.poses[:M].cpu().numpy()
    # keyframes meet GT by the frame that created them (MapState.frame_ids)
    gt_kf = _associate(kf_poses_before, poses_gt, est,
                       frame_ids=m.frame_ids[:M].cpu().numpy())
    res.gt_keyframes = gt_kf
    res.ate_keyframes_before = compute_rmse(gt_kf, kf_poses_before)
    if len(edges_ij) > 0:
        # measured against GT relative pose of each accepted loop edge
        gi, gj = gt_kf[edges_ij[:, 0]], gt_kf[edges_ij[:, 1]]
        d = gj[:, :2] - gi[:, :2]
        c0, s0 = np.cos(gi[:, 2]), np.sin(gi[:, 2])
        rel_gt_xy = np.stack(
            [c0 * d[:, 0] + s0 * d[:, 1], -s0 * d[:, 0] + c0 * d[:, 1]], axis=1)
        err = np.linalg.norm(edges_rel[:, :2] - rel_gt_xy, axis=1)
        res.loop_edge_err_median = float(np.median(err))
        res.loop_edge_err_p90 = float(np.quantile(err, 0.9))
        res.n_loop_edges_bad = int((err > 1.0).sum())
        if progress_every:
            print(f"  backend: edge error median "
                  f"{res.loop_edge_err_median:.2f} m, p90 "
                  f"{res.loop_edge_err_p90:.2f} m, "
                  f"{res.n_loop_edges_bad} bad (>1 m)", flush=True)
    opt = kf_poses_before
    try:
        if res.n_loop_closures > 0:
            opt_poses, _ = optimize_pose_graph(graph, cfg)
            opt = opt_poses[:M].cpu().numpy()
            res.ate_keyframes_after = compute_rmse(gt_kf, opt)
    except Exception as e:  # salvage: keep odometry and the before-ATE
        res.backend_error = f"pose graph: {type(e).__name__}: {e}"[:300]
        print(f"  backend: POSE GRAPH FAILED, salvaging partial results "
              f"({type(e).__name__})", flush=True)
    if partial_write is not None:
        partial_write(res)
    if run_ba and res.backend_error is None:
        if progress_every:
            print("  backend: bundle adjustment...", flush=True)
        try:
            res.ate_keyframes_after_ba, res.n_ba_landmarks, \
                res.n_ba_observations = _run_ba(m, opt, gt_kf, M, cfg)
        except Exception as e:  # salvage: keep the pose-graph results
            res.backend_error = f"BA: {type(e).__name__}: {e}"[:300]
            print(f"  backend: BA FAILED, salvaging pose-graph results "
                  f"({type(e).__name__})", flush=True)


def _run_ba(m, opt_poses, gt_kf, M, cfg: SlamConfig):
    """Schur-complement BA over the trimmed map, poses from the pose graph's
    solution and landmark world positions recomputed from the sensor-local
    observations -> (keyframe ATE after BA, n landmarks, n observations)."""
    prob = build_ba_problem(reseed_map(m, opt_poses))
    # pg_cg_iterations=0: the automatic sweep cap; the PCG's relative-
    # residual exit keeps converged solves cheap
    ba_cfg = dataclasses.replace(cfg, pg_iterations=15, pg_cg_iterations=0)
    poses_ba, _, _ = optimize_ba(prob, ba_cfg)
    ate = compute_rmse(gt_kf, poses_ba[:M].cpu().numpy())
    return ate, int(prob.lm_mask.sum()), int(prob.obs_mask.sum())


def _associate(kf_poses, poses_gt, est_frames, frame_ids=None):
    """GT pose of each keyframe: by its creating-frame index when
    `frame_ids` is given (exact), else by the nearest estimated frame
    position (which can pick the wrong branch near self-intersections)."""
    if frame_ids is not None:
        fid = np.clip(np.asarray(frame_ids, np.int64), 0, len(poses_gt) - 1)
        return poses_gt[fid]
    gt = np.zeros_like(kf_poses)
    for i, kp in enumerate(kf_poses):
        j = np.argmin(np.linalg.norm(est_frames[:, :2] - kp[:2], axis=1))
        gt[i] = poses_gt[j]
    return gt


# --matmul-precision -> torch.set_float32_matmul_precision; "highest" and
# "float32" keep the package's TF32-off rule
_MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                     "tensorfloat32": "high", "bfloat16": "medium"}


def _round(v, nd):
    return round(v, nd) if v is not None else None


def main(argv=None):
    """CLI: long-sequence eval along a GT trajectory, on the card unless
    `--cpu`.

    Example (frames 1040-1399 of an Oxford GT csv):
        python -m radarslampy_tpu_torch.evaluation --gt-csv <csv> \\
            --start 1040 --count 360 --backend
    """
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--gt-csv", default="data/full_seq_1/gt/radar_odometry.csv",
                   help="Oxford GT odometry csv (e.g. one written by "
                        "sim/oxford_files.write_sequence)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--count", type=int, default=200)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--backend", action="store_true",
                   help="run loop closure + pose graph after odometry")
    p.add_argument("--ba", action="store_true",
                   help="run Schur-complement bundle adjustment after the "
                        "pose graph (matrix-free PCG at scale)")
    p.add_argument("--backend-every", type=int, default=0,
                   help="frames between ONLINE backend passes fed back into "
                        "the run (0 = post-hoc only)")
    p.add_argument("--loop-method", default=None,
                   choices=("pose", "appearance", "m2dp", "both"))
    p.add_argument("--cart-size", type=int, default=1024)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch); default: the CUDA device")
    p.add_argument("--progress-every", type=int, default=50)
    p.add_argument("--max-keyframes", type=int, default=None,
                   help="map capacity override (full 9 km run needs ~8192)")
    p.add_argument("--per-scan", type=float, default=80.0,
                   help="target visible landmarks per scan (corridor world)")
    p.add_argument("--world", default="corridor", choices=("corridor", "box"),
                   help="synthetic world model; 'box' is the uniform world "
                        "(ATE numbers are NOT comparable across worlds)")
    p.add_argument("--chunk-frames", type=int, default=0,
                   help="frames per chunk (device render; 0 = per frame)")
    p.add_argument("--sync-every", type=int, default=1,
                   help="torch.cuda.synchronize every N chunks (0 = every "
                        "64 chunks and at the end)")
    p.add_argument("--renderer", default="max", choices=("max", "sum"),
                   help="blob composition: 'max' = 9x9 scatter-max patches; "
                        "'sum' = additive separable splat as one matmul")
    p.add_argument("--host-render", action="store_true",
                   help="render scans on the host even when chunking (A/B "
                        "against the device renderer)")
    p.add_argument("--no-quantize", action="store_true",
                   help="skip u8 quantisation of rendered scans (float A/B; "
                        "the default u8 path mimics PNG ingestion)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory: the chunked run saves "
                        "(state, results, backend edges, cursor) every "
                        "--ckpt-every frames")
    p.add_argument("--ckpt-every", type=int, default=2048)
    p.add_argument("--resume", action="store_true",
                   help="resume from --ckpt-dir if a compatible checkpoint "
                        "exists (config mismatch refuses)")
    p.add_argument("--out", default=None, help="write a JSON result artifact")
    p.add_argument("--min-inliers-accept", type=int, default=None,
                   help="override cfg.min_inliers_accept (0 disables the "
                        "degenerate-fit coasting gate)")
    p.add_argument("--no-fusion-barrier", action="store_true",
                   help="accepted for the JAX harness's command lines; no "
                        "effect here (renderer and step are separate calls)")
    p.add_argument("--matmul-precision", default=None,
                   choices=("bfloat16", "tensorfloat32", "float32", "highest"),
                   help="fp32 matmul precision for this run "
                        "(torch.set_float32_matmul_precision); default: TF32 off")
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    dev = resolve_device(device)

    kw = {"cart_size": a.cart_size,
          "cart_downsample": 4096 // a.cart_size}
    if a.loop_method:
        kw["loop_method"] = a.loop_method
    if a.max_keyframes:
        kw["max_keyframes"] = a.max_keyframes
    if a.min_inliers_accept is not None:
        kw["min_inliers_accept"] = a.min_inliers_accept
    cfg = SlamConfig(**kw)
    poses = gt_subsequence(a.gt_csv, a.start, a.count, a.stride)
    dist = float(np.sum(np.linalg.norm(np.diff(poses[:, :2], axis=0), axis=1)))
    print(f"eval: {len(poses)} frames, {dist:.0f} m path, "
          f"cart {a.cart_size}, loop_method {cfg.loop_method}")
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None

    def _artifact(res):
        return {
            "gt_csv": a.gt_csv,
            "start": a.start,
            "count": a.count,
            "path_m": round(dist, 1),
            "world": a.world,
            "seed": a.seed,
            "noise": a.noise,
            "cart_size": a.cart_size,
            "max_keyframes": cfg.max_keyframes,
            "loop_method": cfg.loop_method,
            "backend_every": a.backend_every,
            "chunk_frames": a.chunk_frames,
            "renderer": a.renderer,
            "platform": dev.type,
            "device_name": device_name,
            "frames": res.frames,
            "fps": round(res.fps, 2),
            "n_keyframes": res.n_keyframes,
            "ate_odometry_m": round(res.ate_odometry, 3),
            "n_online_loops": res.n_online_loops,
            "n_loop_closures": res.n_loop_closures,
            "ate_keyframes_before_m": _round(res.ate_keyframes_before, 3),
            "ate_keyframes_after_m": _round(res.ate_keyframes_after, 3),
            "ate_keyframes_after_ba_m": _round(res.ate_keyframes_after_ba, 3),
            "n_ba_landmarks": res.n_ba_landmarks,
            "n_ba_observations": res.n_ba_observations,
            "loop_edge_err_median_m": _round(res.loop_edge_err_median, 3),
            "loop_edge_err_p90_m": _round(res.loop_edge_err_p90, 3),
            "n_loop_edges_bad": res.n_loop_edges_bad,
            "mean_inliers": _round(res.mean_inliers, 1),
            "frac_fit_ok": _round(res.frac_fit_ok, 4),
            "n_retracks": res.n_retracks,
            "backend_error": res.backend_error,
            "rpe_trans_pct": _round(res.rpe_trans_pct, 3),
            "rpe_rot_deg_100m": _round(res.rpe_rot_deg_100m, 3),
            "heading_rmse_deg": _round(res.heading_rmse_deg, 3),
            "quantize": not a.no_quantize,
            "reference_ate_m": 41.81,
        }

    def _write(res):
        # progressive flush: odometry results land on disk before the
        # back-end stages run
        if a.out:
            with open(a.out, "w") as f:
                json.dump(_artifact(res), f, indent=2)

    prev_precision = torch.get_float32_matmul_precision()
    if a.matmul_precision:
        torch.set_float32_matmul_precision(_MATMUL_PRECISION[a.matmul_precision])
    try:
        res = evaluate_sequence(poses, cfg, seed=a.seed,
                                run_backend=a.backend or a.ba, run_ba=a.ba,
                                noise=a.noise, progress_every=a.progress_every,
                                landmarks_per_scan=a.per_scan, world=a.world,
                                backend_every=a.backend_every,
                                chunk_frames=a.chunk_frames,
                                device_render=not a.host_render,
                                renderer=a.renderer,
                                partial_write=_write,
                                sync_every=a.sync_every,
                                quantize=not a.no_quantize,
                                fusion_barrier=not a.no_fusion_barrier,
                                ckpt_dir=a.ckpt_dir,
                                ckpt_every=a.ckpt_every,
                                resume=a.resume,
                                device=dev)
    finally:
        torch.set_float32_matmul_precision(prev_precision)
    print(f"odometry ATE {res.ate_odometry:.2f} m over {res.frames} frames "
          f"({res.fps:.1f} fps), {res.n_keyframes} keyframes, "
          f"{res.n_online_loops} online loops")
    if res.mean_inliers is not None:
        print(f"health: mean inliers {res.mean_inliers:.1f}, fit_ok "
              f"{100 * res.frac_fit_ok:.1f}%, {res.n_retracks} retracks")
    if a.backend or a.ba:
        def _fmt(v):  # None renders as 'n/a (0 loops)'
            return f"{v:.2f} m" if v is not None else "n/a (0 loops)"

        print(f"loop closures: {res.n_loop_closures}; keyframe ATE "
              f"{_fmt(res.ate_keyframes_before)} -> "
              f"{_fmt(res.ate_keyframes_after)}")
        if a.ba:
            print(f"BA ({res.n_ba_landmarks} landmarks, "
                  f"{res.n_ba_observations} obs): keyframe ATE "
                  f"{_fmt(res.ate_keyframes_after_ba)}")
    _write(res)
    return res


if __name__ == "__main__":
    main()
