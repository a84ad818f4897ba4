"""RadarSlamSystem — the user-facing driver of the port.

Counterpart of `radarslampy_tpu/models/system.py`.  Host work only: PNG
decode in worker threads, `frontend.slam_step` on the device for each frame,
and the trajectory, per-frame metrics and checkpoints around it.

Usage:
    sys = RadarSlamSystem("tiny", data_root="data")      # device="cuda"
    result = sys.run()
    print(result.rmse_vs_gt, result.fps)

The back-end runs as in the JAX driver: `optimize_map` (loop closure, pose
graph, optionally BA) after the run with `optimize` or `ba`, and
`incremental_backend` every `backend_every` frames.  The figures (`viz_dir`)
are not ported yet: `run` raises `NotImplementedError` on them.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import DEFAULT_CONFIG, SlamConfig
from radarslampy_tpu_torch.io import oxford
from radarslampy_tpu_torch.models import frontend
from radarslampy_tpu_torch.models.ba import build_ba_problem, optimize_ba, reseed_map
from radarslampy_tpu_torch.models.loopclosure import (close_loops, incremental_backend,
                                                      trim_map_state)
from radarslampy_tpu_torch.models.posegraph import optimize_pose_graph
from radarslampy_tpu_torch.models.trajectory import Trajectory, align_and_rmse
from radarslampy_tpu_torch.utils.checkpoint import load_meta, load_state, save_state


@dataclasses.dataclass
class RunResult:
    trajectory: Trajectory
    gt_trajectory: Optional[Trajectory]
    rmse_vs_gt: Optional[float]
    n_keyframes: int
    frames: int
    seconds: float
    fps: float
    final_state: frontend.SlamState
    # back-end: loop closure + pose graph after the run (run(optimize=True))
    n_loop_closures: int = 0
    # loops found by the online passes (run(backend_every=N))
    n_online_loops: int = 0
    kf_poses_optimized: Optional[np.ndarray] = None
    posegraph_cost: Optional[float] = None
    # bundle adjustment (run(ba=True))
    kf_poses_ba: Optional[np.ndarray] = None
    landmarks_ba: Optional[np.ndarray] = None
    ba_cost: Optional[float] = None
    # per-run health: frames whose rigid fit degenerated, and the worst
    # per-frame inlier count
    n_fit_failures: int = 0
    min_inliers: int = 0


class _Prefetcher:
    """PNG decode in a pool of worker threads (PIL releases the GIL while it
    inflates), reassembled in order, at most `depth` frames ahead of the
    consumer.  A worker's decode error reaches the consumer as `IOError`."""

    def __init__(self, paths: List[str], cfg: SlamConfig, depth: int = 8,
                 workers: int = 4, raw_u8: bool = False):
        self._paths = paths
        self._cfg = cfg
        self._raw_u8 = raw_u8
        self._results: dict = {}
        self._error: Optional[BaseException] = None
        self._ready = threading.Condition(threading.Lock())
        self._next_put = 0
        self._depth = depth
        self._workers = [
            threading.Thread(target=self._work, args=(w, workers), daemon=True)
            for w in range(min(workers, max(len(paths), 1)))
        ]
        for t in self._workers:
            t.start()

    def _work(self, offset: int, stride: int):
        # A decode exception must reach the consumer: a silently dead worker
        # would leave __iter__ waiting forever on the missing index.
        try:
            for i in range(offset, len(self._paths), stride):
                frame = oxford.decode_radar_png(self._paths[i], self._cfg,
                                                raw_u8=self._raw_u8)
                with self._ready:
                    while i - self._next_put > self._depth:
                        if self._error is not None:
                            return
                        self._ready.wait()
                    self._results[i] = frame
                    self._ready.notify_all()
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            with self._ready:
                if self._error is None:
                    self._error = e
                self._ready.notify_all()

    def __iter__(self):
        for i in range(len(self._paths)):
            with self._ready:
                while i not in self._results:
                    if self._error is not None:
                        raise IOError(f"radar frame decode failed (frame {i})") from self._error
                    self._ready.wait()
                frame = self._results.pop(i)
                self._next_put = i + 1
                self._ready.notify_all()
            yield frame


def _row(out: frontend.StepOutput) -> torch.Tensor:
    """[x, y, theta, n_tracked, n_inliers, fit_ok, is_keyframe, did_retrack]
    of one frame, kept on the step's device until the run fetches all rows."""
    f32 = out.pose.dtype
    return torch.cat([out.pose, torch.stack([
        out.n_tracked.to(f32), out.n_inliers.to(f32), out.fit_ok.to(f32),
        out.is_keyframe.to(f32), out.did_retrack.to(f32)])])


def _fetch(rows: List[torch.Tensor]) -> np.ndarray:
    if not rows:
        return np.zeros((0, 8), np.float32)
    return torch.stack(rows).cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RadarSlamSystem:
    def __init__(
        self,
        sequence: str,
        data_root: str = "data",
        cfg: SlamConfig = DEFAULT_CONFIG,
        progress: Optional[Callable[[int, frontend.StepOutput], None]] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.sequence = sequence
        self.device = resolve_device(device)
        self.paths = oxford.sequence_paths(data_root, sequence)
        self.img_paths = oxford.radar_image_paths(
            self.paths["radar"], self.paths["timestamps"]
        )
        self.maps = frontend.build_frame_maps(cfg, self.device)
        self.progress = progress

        # ground truth (optional: a sequence may not ship one)
        self.gt_traj: Optional[Trajectory] = None
        try:
            stamps, poses, _ = oxford.load_gt_trajectory(self.paths["gt"])
            self.gt_traj = Trajectory(stamps, poses)
        except (OSError, ValueError):
            pass

    def initial_pose(self, timestamp: int) -> np.ndarray:
        if self.gt_traj is not None:
            return np.asarray(self.gt_traj.pose_at_times(timestamp))
        return np.zeros(3)

    def optimize_map(self, state: frontend.SlamState, ba: bool = False):
        """Back-end pass over the finished map: loop closure and the pose
        graph, then, with `ba`, Schur-complement bundle adjustment over the
        persistent landmarks, on the state's device -> (pose-graph keyframe
        poses [M, 3] or None, n_loop_closures, pg cost or None, BA keyframe
        poses or None, BA landmarks or None, BA cost or None)."""
        m = trim_map_state(state.map)
        graph, matches = close_loops(m, self.cfg)
        n_loops = int(matches.ok.sum())
        M = int(m.cursor)
        kf_pg, pg_cost = None, None
        if n_loops > 0:
            poses, cost = optimize_pose_graph(graph, self.cfg)
            kf_pg, pg_cost = poses[:M].cpu().numpy(), float(cost)

        kf_ba, lm_ba, ba_cost = None, None, None
        if ba:
            if kf_pg is not None:
                # seed BA from the loop-corrected poses; the world landmark
                # estimates were anchored to the drifted odometry poses
                m = reseed_map(m, kf_pg)
            problem = build_ba_problem(m, min_views=2)
            if bool(problem.lm_mask.any()):
                poses_b, lms, cost_b = optimize_ba(problem, self.cfg)
                kf_ba = poses_b[:M].cpu().numpy()
                lm_ba = lms[problem.lm_mask].cpu().numpy()
                ba_cost = float(cost_b)
        return kf_pg, n_loops, pg_cost, kf_ba, lm_ba, ba_cost

    @staticmethod
    def _write_metrics(path, start, stamps, rows, online_events):
        """Write the per-frame JSONL metrics, one record per stepped frame
        (`rows`: the fetched [n, 8] per-frame block, see `_row`), with
        `online_loops_closed` on frames whose online pass closed loops."""
        with open(path, "w") as f:
            for k, (ts, row) in enumerate(zip(stamps, rows)):
                nt, ni, ok, kf, rt = row[3:8]
                rec = {
                    "frame": start + k + 1,
                    "timestamp": int(ts),
                    "n_tracked": int(nt),
                    "n_inliers": int(ni),
                    "fit_ok": bool(ok),
                    "is_keyframe": bool(kf),
                    "did_retrack": bool(rt),
                }
                nl = online_events.get(start + k + 1)
                if nl:
                    rec["online_loops_closed"] = int(nl)
                f.write(json.dumps(rec) + "\n")

    def run(self, start: int = 0, end: int = -1, optimize: bool = False,
            ba: bool = False, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 0,
            resume_from: Optional[str] = None,
            backend_every: int = 0,
            viz_dir: Optional[str] = None,
            viz_every: int = 3,
            metrics_path: Optional[str] = None,
            frame_source=None) -> RunResult:
        """Run the SLAM pipeline over frames [start, end] of the sequence.

        `metrics_path`: write one JSON record per stepped frame (frame index,
        timestamp, n_tracked, n_inliers, fit_ok, keyframe and retrack flags).
        The per-frame values stay on the device as [8] rows and are fetched
        once at the end.

        `checkpoint_dir` / `checkpoint_every`: save the state and the
        trajectory so far every `checkpoint_every` frames, and at the end.
        `resume_from`: a directory written that way (by this package or by
        the JAX one); the run restores it and continues from the frame after
        it, so `start` comes from the checkpoint.

        `frame_source`: an iterable of frames (objects with `.power`, the
        [A, Wpad] u8 or float scan, and `.frame_timestamp`) used in place of
        the sequence's PNGs; `end` then defaults to `start`.

        `optimize` / `ba`: after the last frame, `optimize_map` (loop closure
        and pose graph; with `ba` also bundle adjustment) fills the result's
        back-end fields.  `backend_every`: every that many frames an online
        pass (`incremental_backend`) verifies the loops of the keyframes
        added since the last pass, re-solves the pose graph and feeds the
        corrected poses back into the running state; 0 = none.  The final
        checkpoint holds that re-anchored state.

        `viz_dir` raises `NotImplementedError`: `viz/plots.py` is not ported
        yet (ROADMAP.md Queue 1, item 8).  `viz_every` only applies with
        `viz_dir`.
        """
        if viz_dir:
            raise NotImplementedError(
                "viz_dir needs viz/plots.py, which is not ported yet "
                "(ROADMAP.md Queue 1, item 8)")
        cfg, dev = self.cfg, self.device
        est = Trajectory()
        state = None
        if resume_from is not None:
            meta = load_meta(resume_from)
            if "next_frame_index" not in meta:
                raise ValueError(
                    f"checkpoint at {resume_from} has no 'next_frame_index' "
                    f"metadata — written by an older or incompatible build")
            start = int(meta["next_frame_index"])
            state, traj = load_state(resume_from, cfg, dev)
            if traj is not None:
                for ts, pose in zip(*traj):
                    est.append(int(ts), pose)
        resumed = state is not None
        if end < 0:
            end = len(self.img_paths) - 1 if frame_source is None else start
        if resumed and start > end:
            raise ValueError(f"checkpoint already covers frames through {start - 1}; "
                             f"nothing to resume (end={end})")
        if frame_source is not None:
            frames = frame_source
        else:
            if not 0 <= start <= end < len(self.img_paths):
                raise ValueError(f"frames [{start}, {end}] outside the sequence's "
                                 f"{len(self.img_paths)} frames")
            # raw u8 power: dequantised on the device by the step
            frames = _Prefetcher(self.img_paths[start:end + 1], cfg, raw_u8=True)
        it = iter(frames)
        if not resumed:
            first = next(it)
            init_pose = self.initial_pose(first.frame_timestamp)
            state = frontend.init_state(first.power, init_pose, self.maps, cfg)
            est.append(first.frame_timestamp, init_pose)
        last_abs = start if not resumed else start - 1

        # fps counts from the end of the first step (its warm-up excluded)
        t0 = time.perf_counter()
        n = 0
        n_online_loops = 0
        backend_state = None
        online_events = {}
        stamps: List[int] = []
        rows: List[torch.Tensor] = []
        for frame in it:
            state, out = frontend.slam_step(state, frame.power, self.maps, cfg)
            stamps.append(frame.frame_timestamp)
            rows.append(_row(out))
            n += 1
            last_abs += 1
            if n == 1:
                _sync(dev)
                t0 = time.perf_counter()
            if self.progress is not None:
                self.progress(n, out)
            if backend_every and n % backend_every == 0:
                state, nl, _, backend_state = incremental_backend(
                    state, cfg, backend_state=backend_state)
                n_online_loops += nl
                if nl:
                    online_events[start + n] = nl
            if checkpoint_dir and checkpoint_every and n % checkpoint_every == 0:
                partial = Trajectory(est.timestamps, est.poses)
                for ts, pose in zip(stamps, _fetch(rows)[:, :3]):
                    partial.append(ts, pose)
                save_state(checkpoint_dir, state, partial,
                           meta={"next_frame_index": last_abs + 1})
        _sync(dev)
        dt = time.perf_counter() - t0
        rows_np = _fetch(rows)
        for ts, pose in zip(stamps, rows_np[:, :3]):
            est.append(ts, pose)
        if metrics_path:
            self._write_metrics(metrics_path, start, stamps, rows_np, online_events)
        inlier_counts = rows_np[:, 4].astype(int) if len(rows_np) else np.array([0])
        n_fit_failures = int(np.sum(rows_np[:, 5] == 0.0))

        rmse = None
        if self.gt_traj is not None and len(est.timestamps) > 1:
            rmse, _, _ = align_and_rmse(self.gt_traj, est)

        kf_opt, n_loops, pg_cost = None, 0, None
        kf_ba, lm_ba, ba_cost = None, None, None
        if optimize or ba:
            kf_opt, n_loops, pg_cost, kf_ba, lm_ba, ba_cost = self.optimize_map(state, ba=ba)

        if checkpoint_dir:
            save_state(checkpoint_dir, state, est,
                       meta={"next_frame_index": last_abs + 1})

        return RunResult(
            trajectory=est,
            gt_trajectory=self.gt_traj,
            rmse_vs_gt=rmse,
            n_keyframes=int(state.map.cursor),
            frames=n + (0 if resumed else 1),
            seconds=dt,
            fps=(n - 1) / dt if dt > 0 and n > 1 else float("inf"),
            final_state=state,
            n_loop_closures=n_loops,
            n_online_loops=n_online_loops,
            kf_poses_optimized=kf_opt,
            posegraph_cost=pg_cost,
            kf_poses_ba=kf_ba,
            landmarks_ba=lm_ba,
            ba_cost=ba_cost,
            n_fit_failures=n_fit_failures,
            min_inliers=int(inlier_counts.min()),
        )
