#!/usr/bin/env python3
"""Device time of the DoH kernel beside an earlier build of it and beside
copies of it with parts cut out, on one card.

    mkdir -p _parent
    git show e20093f:radarslampy_tpu_torch/csrc/doh.cu > _parent/doh_old.cu
    python3 doh_ab.py [--old _parent/doh_old.cu]

Every run takes one smoothed random image at S = 1024, the sigmas of
`SlamConfig()` and chip_smoke's CUDA-graph timer (device time per call).

- `--old` is the two-pass kernel that csrc/doh.cu replaced, whose entry point
  is `doh_response_launch(img, taps, radius, sig4, n_sigma, tap_stride, rmax,
  S, tmp, out, stream)` (radius and sig4 on the device, an [n_sigma, S, S]
  scratch `tmp`).  Old and current kernel are held to the twin with
  chip_smoke's per-sigma tolerance, then timed old, new, new, old, twice.
- Cuts: copies of csrc/doh.cu with loops cut out (each edit must match the
  source exactly once, or the script fails), built into _build/ and launched
  with the package's launch geometry, each between two timings of the current
  kernel.  Their outputs are wrong by design and are not checked.  Beside them,
  `zero_()` of a tensor of the output's size: the card writing those bytes.
- The current kernel on each sigma alone.
Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys

S = 1024
ROUNDS = 2

ITEMS = "for (int n = schedule[blockIdx.x]; n < schedule[blockIdx.x + 1]; ++n) {"
PHASE_V = "for (int it = warp; it < n_items; it += kThreads / 32) {"
PHASE_H = "for (int i = tid; i < kRows * (kNB / kRH); i += kThreads) {"
APRON = "if (tid < 2 * kRows) {"
PHASE_S = "for (int i = tid; i < rows_out * (kTW / 4); i += kThreads) {"
TAPS = "for (int k = 0; k < kR; ++k) {"


def cut_loop(line):
    """The loop or branch of `line` with a condition that never holds."""
    head, cond = line.split("(", 1)
    if head.strip() == "for":
        init, rest = cond.split(";", 1)
        return f"{head}({init}; false &&{rest}"
    return f"{head}(false && {cond}"


# name -> the edits that make it from csrc/doh.cu
CUTS = {
    "no_items": [(ITEMS, cut_loop(ITEMS))],  # launch and the taps' staging only
    "stencil_and_stores_only": [(l, cut_loop(l)) for l in (PHASE_V, PHASE_H, APRON)],
    "without_phase_v": [(PHASE_V, cut_loop(PHASE_V))],
    "phase_v_only": [(l, cut_loop(l)) for l in (PHASE_H, APRON, PHASE_S)],
    "one_tap_in_8": [(TAPS, TAPS.replace("k < kR", "k < 1"))],  # loads kept, 1/8 of the FMAs
}


def bind(lib, argtypes):
    fn = lib.doh_response_launch
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("doh_ab: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    import chip_smoke
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="path of the two-pass doh.cu to time beside the current")
    args = ap.parse_args()

    sigmas = SlamConfig().doh_sigmas
    filters = doh_cuda.build_doh_filters(sigmas, "cuda")
    n_sigma, tap_stride = filters.taps.shape
    g = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand((S, S), generator=g, device="cuda")
    img = torch.nn.functional.avg_pool2d(img[None, None], 5, 1, 2)[0, 0].contiguous()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def new():
        return doh_cuda.doh_response_cuda(img, filters)

    def current_abi(path):
        """A launcher of the build of `path`, called as the package's wrapper
        calls csrc/doh.cu."""
        fn = bind(ctypes.CDLL(str(doh_cuda.build_library(path))), doh_cuda.LAUNCH_ARGTYPES)
        geom, schedule = doh_cuda._launch_plan(S, filters.radii, 1, img.device)
        radii, sig4 = doh_cuda._host_scalars(filters.radii, filters.scales)

        def run():
            out = torch.empty((n_sigma, S, S), device="cuda")
            err = fn(img.data_ptr(), filters.taps.data_ptr(), radii, sig4, n_sigma,
                     tap_stride, S, 1, S * S, schedule.data_ptr(), geom.grid, geom.block,
                     geom.smem_bytes, out.data_ptr(), stream())
            if err != 0:
                raise RuntimeError(f"{path}: doh_response_launch failed: cudaError {err}")
            return out
        return run

    def two_pass_abi(path):
        fn = bind(ctypes.CDLL(str(doh_cuda.build_library(path))),
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        radius = torch.as_tensor(filters.radii, dtype=torch.int32, device="cuda")
        sig4 = torch.as_tensor(filters.scales, dtype=torch.float32, device="cuda")

        def run():
            out = torch.empty((n_sigma, S, S), device="cuda")
            tmp = torch.empty_like(out)
            err = fn(img.data_ptr(), filters.taps.data_ptr(), radius.data_ptr(),
                     sig4.data_ptr(), n_sigma, tap_stride, max(filters.radii), S,
                     tmp.data_ptr(), out.data_ptr(), stream())
            if err != 0:
                raise RuntimeError(f"{path}: doh_response_launch failed: cudaError {err}")
            return out
        return run

    ref = doh_cuda.doh_response_reference(img, filters)
    runs = {"new": new}
    if args.old:
        runs["old"] = two_pass_abi(args.old)
    for name, fn in runs.items():
        out = fn()
        torch.cuda.synchronize()
        for s in range(n_sigma):
            err = float((out[s] - ref[s]).abs().max())
            tol = 2e-3 * float(ref[s].abs().max())
            if not (tol > 0 and err <= tol):
                raise AssertionError(f"{name} kernel, sigma {sigmas[s]}: {err} > {tol}")

    ab = {name: [] for name in runs}
    if args.old:
        for _ in range(ROUNDS):
            for name in ("old", "new", "new", "old"):
                ab[name].append(chip_smoke.graph_ms(runs[name]))

    source = doh_cuda.SOURCE.read_text()
    doh_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cut_ms, new_ms = {}, []
    for name, edits in CUTS.items():
        text = source
        for a, b in edits:
            if text.count(a) != 1:
                raise AssertionError(f"cut {name}: {a!r} is in csrc/doh.cu "
                                     f"{text.count(a)} times, not once")
            text = text.replace(a, b)
        path = doh_cuda.BUILD_DIR / f"doh_{name}.cu"
        path.write_text(text)
        fn = current_abi(path)
        new_ms.append(chip_smoke.graph_ms(new))
        cut_ms[name] = chip_smoke.graph_ms(fn)
    new_ms.append(chip_smoke.graph_ms(new))
    out = torch.empty((n_sigma, S, S), device="cuda")
    zero_ms = chip_smoke.graph_ms(out.zero_)

    per_sigma = {}
    for sigma in sigmas:
        f1 = doh_cuda.build_doh_filters((sigma,), "cuda")
        per_sigma[str(sigma)] = chip_smoke.graph_ms(
            lambda f1=f1: doh_cuda.doh_response_cuda(img, f1))
    bound, bound_by = doh_cuda.doh_bound_ms(S, filters.radii)
    res = {"S": S, "sigmas": list(sigmas), "bound_ms": bound, "bound_by": bound_by}
    if args.old:
        old, cur = statistics.median(ab["old"]), statistics.median(ab["new"])
        res.update(old_ms=ab["old"], new_ms=ab["new"], old_median_ms=old,
                   new_median_ms=cur, speedup=old / cur, new_bound_share=bound / cur)
    res.update(new_around_cuts_ms=new_ms, cut_ms=cut_ms, zero_output_ms=zero_ms,
               new_per_sigma_ms=per_sigma)
    print(profiling.card_line(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
