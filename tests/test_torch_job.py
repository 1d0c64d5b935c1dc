"""The port's job submission on the port's own cluster, on the CPU: the 8
cases of ``tests/test_job.py`` (REST submit, status, logs, stop, retries,
a job that joins the cluster, listing and deleting, duplicate ids,
tailing), and where a job meets the GPU.

The cluster is made once for the module with ``{"GPU": 1}`` declared (the
CPU tests run without a card). A job's supervisor is a GPU-less actor, so its
entrypoint runs with ``CUDA_VISIBLE_DEVICES=""``; the job reaches the GPU
only through a lease of its own, as a ``num_gpus=1`` task.
"""

import os
import tempfile
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.job import JobSubmissionClient, start_job_server, stop_job_server
from ray_tpu_torch.util.reaper import find_runtime_pids, pid_alive


@pytest.fixture(scope="module")
def client():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(num_cpus=4, resources={"GPU": 1})
        try:
            server = start_job_server(port=0)
            yield JobSubmissionClient(f"http://127.0.0.1:{server.port}")
            stop_job_server()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 10
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)


def test_job_succeeds_with_logs(client):
    job_id = client.submit_job(
        entrypoint="python -c \"print('hello from job'); print('line two')\""
    )
    assert client.get_job_status(job_id) in ("PENDING", "RUNNING", "SUCCEEDED")
    assert client.wait_until_terminal(job_id, timeout=120) == "SUCCEEDED"
    logs = client.get_job_logs(job_id)
    assert "hello from job" in logs and "line two" in logs
    info = client.get_job_info(job_id)
    assert info["entrypoint"].startswith("python -c")
    assert info["end_time"] >= info["start_time"]


def test_job_failure_surfaces(client):
    job_id = client.submit_job(
        entrypoint="python -c \"import sys; print('about to die'); sys.exit(3)\""
    )
    assert client.wait_until_terminal(job_id, timeout=120) == "FAILED"
    assert "code 3" in client.get_job_info(job_id)["message"]
    assert "about to die" in client.get_job_logs(job_id)


def test_job_entrypoint_retries(client):
    """A flaky entrypoint succeeds on retry: the first attempt fails on a
    marker file."""
    marker = tempfile.mktemp()
    script = (
        "import os,sys;"
        f"p={marker!r};"
        "first=not os.path.exists(p);"
        "open(p,'w').write('x');"
        "print('attempt', 'first' if first else 'second');"
        "sys.exit(1 if first else 0)"
    )
    job_id = client.submit_job(entrypoint=f'python -c "{script}"', entrypoint_num_retries=2)
    assert client.wait_until_terminal(job_id, timeout=120) == "SUCCEEDED"
    logs = client.get_job_logs(job_id)
    assert "attempt first" in logs and "attempt second" in logs
    assert "entrypoint retry 1/2" in logs
    os.unlink(marker)


def test_job_stop(client):
    job_id = client.submit_job(
        entrypoint="python -c \"import time; print('sleeping',flush=True); time.sleep(600)\""
    )
    deadline = time.monotonic() + 60
    while client.get_job_status(job_id) != "RUNNING":
        assert time.monotonic() < deadline
        time.sleep(0.2)
    while "sleeping" not in client.get_job_logs(job_id):
        assert time.monotonic() < deadline
        time.sleep(0.2)
    assert client.stop_job(job_id)
    assert client.wait_until_terminal(job_id, timeout=60) == "STOPPED"


def test_job_runs_cluster_workload(client):
    """The entrypoint connects back to this cluster through the injected
    RAY_TPU_ADDRESS and talks to an actor the submitting driver made."""

    @rt.remote(name="job_witness", lifetime="detached", num_cpus=0)
    class Witness:
        def ping(self):
            return "seen-by-job"

    w = Witness.remote()
    ns = rt.get_runtime_context().namespace
    script = (
        "import os,ray_tpu_torch;"
        "assert os.environ.get('RAY_TPU_ADDRESS'), 'no cluster address injected';"
        "ray_tpu_torch.init();"
        f"a=ray_tpu_torch.get_actor('job_witness', namespace='{ns}');"
        "print('witness', ray_tpu_torch.get(a.ping.remote(), timeout=60));"
        "f=ray_tpu_torch.remote(lambda x: x*7);"
        "print('answer', ray_tpu_torch.get(f.remote(6), timeout=60));"
        "ray_tpu_torch.shutdown()"
    )
    job_id = client.submit_job(entrypoint=f'python -c "{script}"')
    try:
        assert client.wait_until_terminal(job_id, timeout=180) == "SUCCEEDED", (
            client.get_job_logs(job_id)
        )
        logs = client.get_job_logs(job_id)
        assert "witness seen-by-job" in logs
        assert "answer 42" in logs
    finally:
        rt.kill(w)


def test_job_list_and_delete(client):
    job_id = client.submit_job(entrypoint="python -c \"print('quick')\"")
    client.wait_until_terminal(job_id, timeout=120)
    assert any(j["job_id"] == job_id for j in client.list_jobs())
    assert client.delete_job(job_id)
    assert all(j["job_id"] != job_id for j in client.list_jobs())
    with pytest.raises(RuntimeError, match="404"):
        client.get_job_status(job_id)


def test_duplicate_submission_id_rejected(client):
    job_id = client.submit_job(entrypoint="python -c \"print('a')\"")
    with pytest.raises(RuntimeError, match="409"):
        client.submit_job(entrypoint="echo x", submission_id=job_id)
    client.wait_until_terminal(job_id, timeout=120)


def test_tail_job_logs(client):
    script = (
        "import time\n"
        "for i in range(5):\n"
        "    print('tick', i, flush=True)\n"
        "    time.sleep(0.3)\n"
    )
    job_id = client.submit_job(entrypoint=f"python -c \"{script}\"")
    chunks = list(client.tail_job_logs(job_id, poll_s=0.2))
    full = "".join(chunks)
    for i in range(5):
        assert f"tick {i}" in full
    assert len(chunks) >= 2  # incremental, not one dump


def test_job_reaches_the_gpu_only_through_a_lease(client):
    """The entrypoint runs under the GPU-less supervisor: it sees
    ``CUDA_VISIBLE_DEVICES=""``, and a ``num_gpus=1`` task it submits gets
    GPU id 0; the GPU is free again once the job is done. Its log lives
    under the port's host directory, not the JAX package's."""
    from ray_tpu_torch._host import TMP_ROOT

    script = (
        "import os,ray_tpu_torch as rt;"
        "print('entrypoint', repr(os.environ.get('CUDA_VISIBLE_DEVICES')));"
        "rt.init();"
        "f=rt.remote(num_gpus=1)(lambda: os.environ.get('CUDA_VISIBLE_DEVICES'));"
        "print('task', repr(rt.get(f.remote(), timeout=60)));"
        "rt.shutdown()"
    )
    job_id = client.submit_job(entrypoint=f'python -c "{script}"')
    assert client.wait_until_terminal(job_id, timeout=180) == "SUCCEEDED", (
        client.get_job_logs(job_id)
    )
    logs = client.get_job_logs(job_id)
    assert "entrypoint ''" in logs and "task '0'" in logs
    assert os.path.exists(os.path.join(TMP_ROOT, "jobs", f"{job_id}.log"))
    deadline = time.monotonic() + 10
    while rt.available_resources().get("GPU") != 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert rt.available_resources().get("GPU") == 1


def test_a_job_driver_returns_its_leases_as_it_exits(client):
    """An entrypoint that shuts down straight after its last ``get`` still
    returns the lease its tasks ran on: every CPU is back once each job is
    done. Three jobs in a row, since the lease outlives the task only for
    its linger."""
    total = rt.cluster_resources()["CPU"]
    script = (
        "import ray_tpu_torch as rt;"
        "rt.init();"
        "f=rt.remote(lambda x: x+1);"
        "print('sum', sum(rt.get([f.remote(i) for i in range(4)], timeout=60)));"
        "rt.shutdown()"
    )
    for _ in range(3):
        job_id = client.submit_job(entrypoint=f'python -c "{script}"')
        assert client.wait_until_terminal(job_id, timeout=180) == "SUCCEEDED", (
            client.get_job_logs(job_id))
        assert "sum 10" in client.get_job_logs(job_id)
        deadline = time.monotonic() + 10
        while rt.available_resources().get("CPU") != total and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rt.available_resources().get("CPU") == total


def _gang_pids():
    """Pids of the training gang's live worker actors (``TrainWorker``)."""
    from ray_tpu_torch.util import state

    return [a["pid"] for a in state.list_actors()
            if a["class_name"].startswith("TrainWorker") and a["state"] == "ALIVE"]


def _submit_training(client, tmp_path, steps, name):
    import json

    import numpy as np

    rows = np.random.RandomState(7).randint(0, 256, size=(steps * 2, 17))
    np.save(tmp_path / "rows.npy", rows)
    config = {"model": {"preset": "tiny"}, "seed": 0, "lr": 1e-3, "remat": "selective",
              "batch_size": 2}
    entrypoint = (f"python -m ray_tpu_torch.tools.train_llama --platform cpu --name {name} "
                  f"--storage {tmp_path} --rows {tmp_path / 'rows.npy'} "
                  f"--config '{json.dumps(config)}'")
    return client.submit_job(entrypoint=entrypoint), rows


def test_training_job_through_the_trainer(client, tmp_path):
    """A job whose entrypoint is ``python -m ray_tpu_torch.tools.train_llama``
    trains tiny Llama through ``TorchTrainer`` on the cluster it was given:
    its losses, read from the job's logs, equal the single-process step on
    the same rows within rtol 2e-4 (``test_torch_train.py``'s bound)."""
    import json

    import numpy as np
    import torch

    from ray_tpu_torch.models import llama as tl

    job_id, rows = _submit_training(client, tmp_path, 3, "job-train")
    assert client.wait_until_terminal(job_id, timeout=180) == "SUCCEEDED", (
        client.get_job_logs(job_id))
    lines = [json.loads(line) for line in client.get_job_logs(job_id).splitlines()
             if line.startswith("{")]
    assert lines[0]["entrypoint"]["cuda_visible_devices"] == ""
    losses = [m["loss"] for m in lines[1:] if "loss" in m]
    done = lines[-1]
    assert done["done"] and done["backend"] == "gloo" and done["world_size"] == 1
    assert done["losses"] == losses

    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, device="cpu")
    state, step, ref = (model, tl.adamw(1e-3)(model.parameters())), tl.make_train_step(cfg), []
    for i in range(3):
        batch = torch.from_numpy(rows[2 * i: 2 * (i + 1)])
        state, loss = step(state, {"tokens": batch[:, :-1], "targets": batch[:, 1:]})
        ref.append(float(loss))
    np.testing.assert_allclose(losses, ref, rtol=2e-4)


def test_stopping_a_training_job_frees_its_gang(client, tmp_path):
    """``stop_job`` on a job mid-training: SIGTERM ends the entrypoint's fit
    through ``SystemExit``, the trainer shuts its gang down, the job reads
    STOPPED, the entrypoint and the gang's worker are gone and every CPU is
    back."""
    import re

    total = rt.cluster_resources()["CPU"]
    job_id, _rows = _submit_training(client, tmp_path, 2000, "job-stop")
    deadline = time.monotonic() + 120
    while not _gang_pids():
        assert time.monotonic() < deadline, client.get_job_logs(job_id)
        assert client.get_job_status(job_id) in ("PENDING", "RUNNING"), (
            client.get_job_logs(job_id))
        time.sleep(0.2)
    gang = _gang_pids()
    entrypoint = int(re.search(r'"pid": (\d+)', client.get_job_logs(job_id)).group(1))
    assert client.stop_job(job_id)
    assert client.wait_until_terminal(job_id, timeout=60) == "STOPPED"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and (
            pid_alive(entrypoint) or any(pid_alive(p) for p in gang)
            or rt.available_resources().get("CPU") != total):
        time.sleep(0.1)
    assert not pid_alive(entrypoint) and not any(pid_alive(p) for p in gang)
    assert rt.available_resources().get("CPU") == total
