"""The port's multi-host bootstrap (parallel/bootstrap.py), its launcher
(parallel/launch.py) and the CLI's --mesh, on this host's CPU over gloo.

As in the reference's tests/test_bootstrap.py, real N >= 2-host runs need
N machines: what runs here is the wiring. ``init_multihost`` on a
1-process group, from the reference's environment variables, from its
arguments and from torchrun's variables, each in a subprocess so that no
process group outlives it in the test process; the launcher's deadline and
failure reports; the distributed dry run; and ``--mesh 4`` with every
schedule.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark_spgemm_using_csr_tpu_torch import cli
from benchmark_spgemm_using_csr_tpu_torch.parallel import bootstrap, launch
from benchmark_spgemm_using_csr_tpu_torch.parallel.launch import (
    dryrun_multichip,
    free_port,
    spawn,
)

import _torch_dist_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK")

_CHILD = r"""
import json
import torch

from benchmark_spgemm_using_csr_tpu_torch.parallel.bootstrap import (
    global_mesh, init_multihost, shutdown,
)

topo = init_multihost(device="cpu")  # topology from env vars
assert topo.process_count == 1 and topo.process_id == 0, topo
topo2 = init_multihost(device="cpu")  # idempotent second call
assert topo2.process_count == 1

mesh = global_mesh()
assert mesh.size == topo.global_devices

from benchmark_spgemm_using_csr_tpu_torch.parallel.dist import dist_spgemm
from benchmark_spgemm_using_csr_tpu_torch.sparse.csr import CSR
from benchmark_spgemm_using_csr_tpu_torch.utils.generators import erdos_renyi
from benchmark_spgemm_using_csr_tpu_torch.utils.oracle import (
    assert_csr_equal, spgemm_reference,
)

a = CSR.from_scipy(erdos_renyi(96, 96, 4.0, seed=5), device=mesh.device)
for schedule in ("replicated", "ring", "halo"):
    c = dist_spgemm(a, a, mesh, schedule=schedule)
    assert_csr_equal(c, spgemm_reference(a, a), rtol=1e-4, atol=1e-5)
shutdown()
assert not torch.distributed.is_initialized()
print(json.dumps({"ok": True, "devices": topo.global_devices,
                  "backend": topo.backend, "device": str(topo.device)}))
"""


def clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY_VARS}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("via", ["env", "args", "torchrun"])
def test_bootstrap_one_process(via):
    port = free_port()
    child = _CHILD
    env = clean_env()
    if via == "env":
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="1",
                   PROCESS_ID="0")
    elif via == "torchrun":
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    else:
        child = child.replace(
            'init_multihost(device="cpu")  # topology from env vars',
            f'init_multihost("127.0.0.1:{port}", 1, 0, device="cpu")',
        )
    out = subprocess.run([sys.executable, "-c", child], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == {"ok": True, "devices": 1, "backend": "gloo",
                   "device": "cpu"}


def test_bootstrap_needs_a_topology(monkeypatch):
    for k in TOPOLOGY_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator address"):
        bootstrap.init_multihost(device="cpu")


@pytest.mark.parametrize("schedule", ["replicated", "ring", "halo"])
def test_cli_mesh_4_on_gloo(schedule, capsys):
    rc = cli.main(["gen:powerlaw:512", "--device", "cpu", "--mesh", "4",
                   "--schedule", schedule, "--json", "--runs", "1",
                   "--warmup", "0"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["verified"] is True
    assert record["method"] == f"dist/{schedule}x4"
    assert record["device"] == "cpu" and record["m"] == 512


def test_cli_multihost_one_process():
    """--multihost: this process is rank 0 of a 1-process job."""
    env = clean_env(COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                    NUM_PROCESSES="1", PROCESS_ID="0")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark_spgemm_using_csr_tpu_torch",
         "gen:er:128", "--device", "cpu", "--multihost", "--mesh", "1",
         "--schedule", "ring", "--json", "--runs", "1", "--warmup", "0"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    record = json.loads(out.stdout.strip().splitlines()[-1])
    assert record["method"] == "dist/ringx1" and record["verified"] is True


def test_cli_mesh_refuses_other_ops():
    with pytest.raises(SystemExit, match="--mesh runs --op spgemm"):
        cli.main(["gen:er:64", "--device", "cpu", "--mesh", "2", "--op",
                  "spmv"])


def test_spawn_kills_a_group_past_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline"):
        spawn(_torch_dist_ranks.sleep_rank, 2, 300.0, device="cpu",
              timeout_s=5.0)
    assert time.monotonic() - t0 < 60


def test_spawn_reports_a_failing_rank():
    """The failing rank's traceback reaches the caller (beside what its
    peers report when the failure stops them)."""
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn(_torch_dist_ranks.fail_rank, 2, device="cpu", timeout_s=60.0,
              pg_timeout_s=20.0)


def test_dryrun_multichip():
    """The reference's dry run (skewed power-law, every schedule, against
    scipy) on 4 gloo ranks."""
    line = dryrun_multichip(4, device="cpu")
    assert "replicated + ring + halo schedules OK" in line
    assert "512 rows" in line and line.endswith("over gloo")


def test_launch_asks_for_the_device():
    """The launcher takes no default device, and its dry run entry point
    runs on the cards unless asked for the CPU: past the visible cards it
    exits with the reference's message."""
    with pytest.raises(TypeError, match="device"):
        spawn(_torch_dist_ranks.sleep_rank, 2, 0.0)
    with pytest.raises(TypeError, match="device"):
        dryrun_multichip(2)
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"need {n} devices, have {n - 1}"):
        launch.main([str(n)])
