"""The port's multi-process launcher (`radarslampy_tpu_torch.parallel.launch`)
on the CPU: one spawn of 2 gloo ranks on a file store in the test's
temporary directory (never a TCP port: the suite runs several pytest workers
at once), under this test's own time limit; and the benches, at small sizes,
in a world of one rank in this process."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from radarslampy_tpu_torch.parallel import launch

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPAWN_S = 120


def _run(args, timeout):
    """Run the launcher in its own session; on the time limit kill the whole
    session (the spawner and its ranks) -> (exit code, stdout)."""
    path = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path)
    p = subprocess.Popen([sys.executable, "-m", "radarslampy_tpu_torch.parallel.launch", *args],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)   # no rank outlives the test
        except ProcessLookupError:
            pass
    return p.returncode, out.decode()


def test_two_rank_smoke(tmp_path):
    out = tmp_path / "smoke.json"
    rc, log = _run(["--spawn", "2", "--smoke", "--cpu", "--coordinator",
                    f"file://{tmp_path}/store", "--out", str(out)], SPAWN_S)
    assert rc == 0, log[-2000:]
    res = json.loads(out.read_text())
    assert res["num_processes"] == 2 and res["global_devices"] == 2
    assert res["psum"] == 2.0 and res["collectives"] == "gloo" and res["device"] == "cpu"
    assert json.loads(log.strip().splitlines()[-1]) == res


def test_local_devices_is_not_accepted(capsys):
    """A rank owns one device: the JAX launcher's --local-devices has no
    counterpart, and the flag is refused, not ignored."""
    with pytest.raises(SystemExit) as exc:
        launch.main(["--spawn", "1", "--local-devices", "2"])
    assert exc.value.code == 2 and "--local-devices" in capsys.readouterr().err


@pytest.fixture
def mesh_of_one(tmp_path):
    from radarslampy_tpu_torch.parallel.mesh import make_mesh

    launch.initialize(f"file://{tmp_path}/store", 1, 0, cpu=True)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_benches_run_in_a_world_of_one(mesh_of_one):
    times, n = launch.bench_verify_mp(mesh_of_one, n_cands=8, reps=2)
    assert n == 8 and len(times) == 2 and min(times) > 0
    for method in ("gather", "pcg"):
        times, cost = launch.bench_posegraph_mp(mesh_of_one, M=64, iters=2, method=method,
                                                reps=1)
        assert len(times) == 1 and np.isfinite(cost) and cost > 0
    times, frames = launch.bench_odometry_mp(mesh_of_one, frames_per_seg=3, reps=1)
    assert frames == 2 and len(times) == 1
    s = launch._stats([3.0, 1.0, 2.0])
    assert s == {"median_s": 2.0, "min_s": 1.0, "max_s": 3.0, "reps": 3}
