"""CLI driver: ``python -m radarslampy_tpu_torch <sequence> [start [end]]``.

The arguments and the printed summary are those of
``python -m radarslampy_tpu``.  The run is on the CUDA device unless `--cpu`
is given; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="radarslampy_tpu_torch",
                                 description="radar SLAM on PyTorch (CUDA)")
    ap.add_argument("sequence", nargs="?", default="tiny")
    ap.add_argument("start", nargs="?", type=int, default=0)
    ap.add_argument("end", nargs="?", type=int, default=-1)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--cart-size", type=int, default=None)
    ap.add_argument("--out-dir", default=None,
                    help="save summary.json, trajectory.npz and trajectory.jpg (against "
                         "GT, with the GPS track where gps/gps.csv exists) here")
    ap.add_argument("--loop-closure", action="store_true",
                    help="loop closure + pose graph over the map at the end")
    ap.add_argument("--ba", action="store_true",
                    help="bundle adjustment over the map at the end (after the "
                         "pose graph when loops close)")
    ap.add_argument("--backend-every", type=int, default=0,
                    help="frames between online loop-closure + pose-graph passes "
                         "fed back into the running state (0: none)")
    ap.add_argument("--viz-dir", default=None,
                    help="save per-frame tracking/trajectory composites here, and at "
                         "the end map.png and (with ffmpeg) run.mp4")
    ap.add_argument("--viz-every", type=int, default=3,
                    help="frames between composites, with --viz-dir")
    ap.add_argument("--metrics", default=None,
                    help="write a per-frame JSONL metrics stream here (frame, "
                         "n_tracked, n_inliers, fit_ok, keyframe/retrack flags)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume-from", default=None,
                    help="resume a run from a checkpoint directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch); default: the CUDA device")
    args = ap.parse_args(argv)

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.system import RadarSlamSystem

    cfg = SlamConfig()
    if args.cart_size:
        ds = cfg.cart_downsample * cfg.cart_size // args.cart_size
        cfg = dataclasses.replace(cfg, cart_size=args.cart_size, cart_downsample=ds)

    sys_ = RadarSlamSystem(args.sequence, data_root=args.data_root, cfg=cfg,
                           device="cpu" if args.cpu else "cuda")
    res = sys_.run(args.start, args.end, optimize=args.loop_closure, ba=args.ba,
                   backend_every=args.backend_every, viz_dir=args.viz_dir,
                   viz_every=args.viz_every,
                   checkpoint_dir=args.checkpoint_dir,
                   checkpoint_every=args.checkpoint_every,
                   resume_from=args.resume_from,
                   metrics_path=args.metrics)

    summary = {
        "sequence": args.sequence,
        "frames": res.frames,
        "keyframes": res.n_keyframes,
        "fps": round(res.fps, 3),
        "rmse_vs_gt_m": round(res.rmse_vs_gt, 3) if res.rmse_vs_gt is not None else None,
    }
    if args.backend_every:
        summary["online_loops"] = res.n_online_loops
    if args.loop_closure:
        summary["loop_closures"] = res.n_loop_closures
        if res.posegraph_cost is not None:
            summary["posegraph_cost"] = res.posegraph_cost
    if args.ba and res.ba_cost is not None:
        summary["ba_cost"] = res.ba_cost
        summary["ba_landmarks"] = int(len(res.landmarks_ba))
    print(json.dumps(summary))

    if args.out_dir:
        import numpy as np

        from radarslampy_tpu_torch.io.oxford import load_gps_trajectory
        from radarslampy_tpu_torch.viz.plots import align_xy, plot_trajectories

        os.makedirs(args.out_dir, exist_ok=True)
        ts, est = res.trajectory.as_arrays()
        gt = res.gt_trajectory.pose_at_times(ts) if res.gt_trajectory is not None else None
        # the GPS track, interpolated at the radar timestamps and rigidly
        # aligned onto the estimate over the frames it covers
        gps_xy = None
        try:
            gps_ts, gps = load_gps_trajectory(sys_.paths["gps"])
            sel = (gps_ts >= ts[0]) & (gps_ts <= ts[-1])
            if sel.sum() >= 2:
                g_ts, g_xy = gps_ts[sel], gps[sel]
                gps_at_radar = np.stack([np.interp(ts, g_ts, g_xy[:, 0]),
                                         np.interp(ts, g_ts, g_xy[:, 1])], axis=1)
                gps_xy = align_xy(gps_at_radar, est[:, :2])
        except (OSError, ValueError, IndexError):
            pass
        plot_trajectories(gt, est, title=args.sequence, rmse=res.rmse_vs_gt,
                          save_path=os.path.join(args.out_dir, "trajectory.jpg"),
                          gps_xy=gps_xy)
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        np.savez(os.path.join(args.out_dir, "trajectory.npz"), timestamps=ts, poses=est)
    return 0


if __name__ == "__main__":
    sys.exit(main())
