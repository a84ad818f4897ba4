#!/usr/bin/env python3
"""Which ops of the step change bits when batched: the step's stages under
`torch.func.vmap` against their single calls, on one card.

    python3 vmap_probe.py [--cpu] [--no-phase13]

1. Stages: D = 4 segments of chip_smoke's arc at `SlamConfig()` (`--cpu`: its
   small config on the CPU).  Each segment's first `slam_step` runs with the
   step's stage functions wrapped to record their arguments and results;
   then each stage is called under vmap on the segments' stacked arguments
   (arguments that are one object for all segments stay unbatched) and its
   results are held against the recorded ones bit for bit.  Prints one line
   a stage: "equal", or the results that differ (result index, segment, max
   abs diff).  Then the vmapped eager step against the single steps over 3
   frames.
2. Raw library calls (the card only), batched against single on random
   inputs of the LM's shapes (J [515, 6], as at K = 256) and the Procrustes
   fit's: `J.T @ J`, `J.T @ r`, a weighted column sum over [K, 2] and a full
   sum of squares, then `cholesky_ex` and `cholesky_solve` under each
   linalg backend, each also captured in a CUDA graph ("ok" or the error).
   These are the calls that `ops/segments.py` runs segment by segment.
3. `chip_smoke.batched_checks` (phase 13), unless `--no-phase13`.
"""

from __future__ import annotations

import argparse
import sys
import time


def stage_diffs(torch, F, geo, pytree, seg, maps, cfg, stages):
    """Each stage's vmapped call against its recorded single calls -> lines."""
    import numpy as np

    D = seg.shape[0]
    log, real = [], {}

    def recorder(name, fn):
        def rec(*a, **k):
            out = fn(*a, **k)
            log.append((name, a, k, out))
            return out
        return rec

    for name in stages:
        real[name] = getattr(F, name)
        setattr(F, name, recorder(name, real[name]))
    real["procrustes_masked"] = geo.procrustes_masked
    geo.procrustes_masked = recorder("procrustes_masked", real["procrustes_masked"])
    calls = []
    try:
        for d in range(D):
            s = F.init_state(seg[d, 0], np.zeros(3), maps, cfg)
            log.clear()
            F.slam_step(s, seg[d, 1], maps, cfg)
            calls.append(list(log))
    finally:
        for name in stages:
            setattr(F, name, real[name])
        geo.procrustes_masked = real["procrustes_masked"]
    lines = []
    for i, (name, _, kwargs, _) in enumerate(calls[0]):
        flat = [pytree.tree_flatten(c[i][1]) for c in calls]
        spec = flat[0][1]
        args, dims = [], []
        for j in range(len(flat[0][0])):
            xs = [f[0][j] for f in flat]
            batched = isinstance(xs[0], torch.Tensor) and not all(x is xs[0] for x in xs)
            args.append(torch.stack(xs) if batched else xs[0])
            dims.append(0 if batched else None)
        out = torch.func.vmap(lambda *a: real[name](*a, **kwargs),
                              in_dims=tuple(pytree.tree_unflatten(dims, spec)))(
            *pytree.tree_unflatten(args, spec))
        diffs = []
        for j, got in enumerate(pytree.tree_flatten(out)[0]):
            for d in range(D):
                want = pytree.tree_flatten(calls[d][i][3])[0][j]
                if not torch.equal(got[d], want):
                    diffs.append((j, d, float((got[d].double() - want.double()).abs().max())))
        lines.append(f"stage {i} {name}: " + ("equal" if not diffs else f"differ {diffs[:8]}"))
    return lines


def library_diffs(torch, D=4):
    """Raw batched library calls against single ones, and their capture."""
    g = torch.Generator(device="cuda").manual_seed(0)
    J = torch.randn((D, 515, 6), generator=g, device="cuda")
    r = torch.randn((D, 515), generator=g, device="cuda")
    pts = torch.randn((D, 256, 2), generator=g, device="cuda")
    w = (torch.rand((D, 256), generator=g, device="cuda") < 0.8).float()
    A = J.transpose(1, 2) @ J + 1e-3 * torch.eye(6, device="cuda")
    vm = torch.func.vmap

    def same(batched, single):
        return all(torch.equal(batched[d], single(d)) for d in range(D))

    lines = [
        f"J.T @ J {same(vm(lambda x: x.T @ x)(J), lambda d: J[d].T @ J[d])}",
        f"J.T @ r {same(vm(lambda x, y: x.T @ y)(J, r), lambda d: J[d].T @ r[d])}",
        "weighted column sum "
        f"{same(vm(lambda p, q: torch.sum(p * q[:, None], dim=0))(pts, w), lambda d: torch.sum(pts[d] * w[d][:, None], dim=0))}",
        f"sum of squares {same(vm(lambda x: torch.sum(x * x))(r), lambda d: torch.sum(r[d] * r[d]))}",
    ]

    def solve(b, L):
        return torch.cholesky_solve(b[:, None], L)[:, 0]

    for lib in ("default", "cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(lib)
        L = vm(lambda a: torch.linalg.cholesky_ex(a)[0])(A)
        x = vm(solve)(r[:, :6], L)
        eq = (same(L, lambda d: torch.linalg.cholesky_ex(A[d])[0]),
              same(x, lambda d: solve(r[d, :6], torch.linalg.cholesky_ex(A[d])[0])))
        cap = {}
        for what, fn in (("cholesky_ex", lambda: vm(lambda a: torch.linalg.cholesky_ex(a)[0])(A)),
                         ("cholesky_solve", lambda: vm(solve)(r[:, :6], L))):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    fn()
                cap[what] = "ok"
            except RuntimeError as exc:   # a diagnostic: report the refusal and go on
                cap[what] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:100]}"
            torch.cuda.synchronize()
        lines.append(f"linalg {lib}: batched equal to single (cholesky_ex, cholesky_solve) {eq}; "
                     f"capture {cap}")
    torch.backends.cuda.preferred_linalg_library("default")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-phase13", action="store_true")
    a = ap.parse_args()
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    if not a.cpu and not torch.cuda.is_available():
        print("vmap_probe: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops import geometry as geo
    from radarslampy_tpu_torch.utils.checkpoint import states_equal
    from radarslampy_tpu_torch.utils.profiling import card_line

    dev = "cpu" if a.cpu else "cuda"
    card = "cpu" if a.cpu else card_line()
    print(f"vmap_probe on {card}, torch {torch.__version__}", flush=True)
    cfg = SlamConfig(**cs.SMALL) if a.cpu else SlamConfig()
    maps = F.build_frame_maps(cfg, dev)
    D, T = 4, 4
    _, frames = cs.render_frames(cfg, 1 + D * 3, seed=6)
    seg = torch.as_tensor(np.stack([frames[k * 3:k * 3 + T] for k in range(D)]), device=dev)
    stages = ["warp_polar_to_cartesian", "track_klt", "reject_outliers", "solve_motion",
              "get_features", "merge_features", "keyframe_pointcloud", "scan_context",
              "assign_new_ids", "_features_to_world", "undistort"]
    t = time.time()
    for line in stage_diffs(torch, F, geo, pytree, seg, maps, cfg, stages):
        print(line, flush=True)
    s = F.batched_init_state(seg[:, 0], torch.zeros(D, 3), maps, cfg)
    singles = [F.init_state(seg[d, 0], np.zeros(3), maps, cfg) for d in range(D)]
    for t_ in range(1, T):
        s, o = F.batched_slam_step(s, seg[:, t_], maps, cfg)
        outs = []
        for d in range(D):
            singles[d], od = F.slam_step(singles[d], seg[d, t_], maps, cfg)
            outs.append(od)
        rows = torch.stack([F.pack_output(x) for x in outs])
        print(f"vmapped eager step, frame {t_}: "
              f"{cs.rows_agree(torch, F.pack_output(o), rows, cfg)}, states equal "
              f"{[states_equal(x, y) for x, y in zip(F.unstack_states(s), singles)]}", flush=True)
    print(f"stages in {time.time() - t:.1f} s", flush=True)
    if a.cpu:
        return 0
    for line in library_diffs(torch):
        print(line, flush=True)
    if not a.no_phase13:
        cs.batched_checks(torch, cfg, maps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
