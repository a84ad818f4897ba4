"""The port's stage timer, device trace and per-stage profiler
(`utils/profiling.py`, `utils/profile_stages.py`), held against the JAX
package's.

The JAX `profile` reads the Oxford "tiny" sequence, which neither machine
has, so its artifact's keys and stage names are read from its source; the
port's `profile` runs on the CPU at the small grid of
tests/test_torch_system.py with 2 calls x 2 trials per stage.
"""

import ast
import collections
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.utils import profiling as jprof
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.utils import profile_stages, profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
SEQUENCE = ["warp", "klt", "warp", "lm", "klt", "warp"]
Pair = collections.namedtuple("Pair", "a b")


def _jax_profile_keys():
    """(artifact keys, stage names) of the JAX `profile`, from its source."""
    tree = ast.parse((ROOT / "radarslampy_tpu/utils/profile_stages.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "profile")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    keys = [k.value for k in ret.value.keys]
    stages = [n.targets[0].slice.value for n in ast.walk(fn)
              if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
              and isinstance(n.targets[0].value, ast.Name) and n.targets[0].value.id == "stages"]
    return keys, stages


@pytest.mark.parametrize("sync", ["none", "tensor", "namedtuple"])
def test_stage_timer_report_matches_jax(sync):
    port, ref = profiling.StageTimer(), jprof.StageTimer()
    x = torch.arange(4.0)
    tree = {"none": None, "tensor": x, "namedtuple": Pair(x, (x, [x * 2]))}[sync]
    jtree = None if sync == "none" else jnp.arange(4.0)
    for name in SEQUENCE:
        with port.stage(name, sync=tree):
            torch.ones(16).sum()
        with ref.stage(name, sync=jtree):
            jnp.ones(16).sum()
    a, b = port.report(), ref.report()
    assert list(a) == list(b) == ["klt", "lm", "warp"]
    for k in a:
        assert list(a[k]) == list(b[k]) == ["total_s", "calls", "mean_ms"]
        assert a[k]["calls"] == b[k]["calls"] == SEQUENCE.count(k)
        assert a[k]["total_s"] >= 0 and a[k]["mean_ms"] >= 0
    assert json.loads(port.dump()) == a


def test_synchronize_finds_no_cuda_tensor_on_the_cpu():
    x = torch.zeros(2)
    assert profiling._devices(Pair(x, {"k": [x, (x,)]})) == set()
    profiling.synchronize(Pair(x, None))


def test_device_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir)):
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_pipelined_and_per_call_timers_count_calls():
    n = []
    dev = torch.device("cpu")
    s = profile_stages._pipelined_time(lambda v: n.append(v), (1,), dev, calls=7, trials=3)
    assert len(n) == 1 + 7 * 3 and s >= 0
    n.clear()
    s = profile_stages._time_fn(lambda: n.append(0), device=dev, iters=4, warmup=2)
    assert len(n) == 6 and s >= 0


def test_profile_on_the_cpu_has_the_jax_keys():
    keys, stages = _jax_profile_keys()
    assert stages == ["polar_to_cart_warp", "doh_detect_anms", "klt_pyramidal",
                      "clique_reject", "procrustes_motion_lm", "scan_context",
                      "keyframe_pointcloud", "fused_slam_step"]
    res = profile_stages.profile(SlamConfig(**KW), iters=2, device="cpu", calls=2, trials=2)
    assert list(res) == keys[:2] + ["device_name"] + keys[2:]
    assert res["platform"] == "cpu" and res["device_name"] is None
    assert res["cart_size"] == 256 and res["iters"] == 2
    assert list(res["stages"]) == stages
    us = [v["us"] for v in res["stages"].values()]
    assert all(math.isfinite(u) and u > 0 for u in us), res
    assert res["fused_step_us"] == res["stages"]["fused_slam_step"]["us"]
    assert res["sum_of_stages_us"] == pytest.approx(sum(us[:-1]), abs=1.0)
    assert math.isfinite(res["fused_step_wall_us_incl_dispatch"])
    assert res["fused_step_wall_us_incl_dispatch"] > 0


def test_profile_frames_are_seeded_u8_scans():
    cfg = SlamConfig(**KW)
    a, b = profile_stages._frames(cfg, None), profile_stages._frames(cfg, None)
    assert len(a) == 2 and all(f.dtype == np.uint8 for f in a)
    assert a[0].shape == (cfg.num_azimuths, cfg.polar_width_padded)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])


def test_profile_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run at full size")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_stages.main(["--iters", "1", "--out", str(tmp_path / "p.json")])
    assert not (tmp_path / "p.json").exists()
