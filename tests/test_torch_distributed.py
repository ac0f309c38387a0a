"""Two-process torch.distributed bring-up on the CPU: the port's
counterpart of tests/test_distributed.py.  Two real processes run
`python -m unicore_tpu_torch.parallel.dist_check` (the counterpart of
tests/dist_worker.py) with the JAX package's three variables, over gloo:
each holds only its block of an SW pair batch and scores it through
`sw_forward_cuda` (its plain version on the CPU), all-reduces the hit
count and all-gathers the results, and checks both against the whole
batch scored locally.  Every wait has a timeout."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_sw():
    env = dict(os.environ, PYTHONPATH=REPO, UNICORE_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               UNICORE_TPU_NUM_PROCS="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "unicore_tpu_torch.parallel.dist_check", "--device", "cpu"],
        env=dict(env, UNICORE_TPU_PROC_ID=str(rank)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "OK procs=2 backend=gloo hits=32 launches=0" in out, out


def test_dist_check_needs_the_coordinator():
    env = {k: v for k, v in os.environ.items() if not k.startswith("UNICORE_TPU_COORDINATOR")}
    res = subprocess.run([sys.executable, "-m", "unicore_tpu_torch.parallel.dist_check", "--device", "cpu"],
                         env=dict(env, PYTHONPATH=REPO), cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and "UNICORE_TPU_COORDINATOR is not set" in res.stderr


def test_initialize_distributed_twice_returns_the_backend_up(monkeypatch):
    """A second call in one process returns the backend already up and
    leaves the group as it was."""
    import torch.distributed as dist

    from unicore_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setenv(mesh_mod.ENV_COORDINATOR, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(mesh_mod.ENV_NUM_PROCS, "1")
    monkeypatch.setenv(mesh_mod.ENV_PROC_ID, "0")
    assert mesh_mod.initialize_distributed(timeout_s=30, backend="gloo") == "gloo"
    try:
        group = dist.group.WORLD
        assert mesh_mod.initialize_distributed(timeout_s=30, backend="gloo") == "gloo"
        assert mesh_mod.initialize_distributed(timeout_s=30) == "gloo"
        assert dist.group.WORLD is group and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
