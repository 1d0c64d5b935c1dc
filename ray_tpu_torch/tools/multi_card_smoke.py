"""Four-card smoke of the port: each sharded path on four NVIDIA cards of one
host, held against the one-card step on the same params and batch.

Run from the root of a checkout::

    python3 -m ray_tpu_torch.tools.multi_card_smoke              # every part
    python3 -m ray_tpu_torch.tools.multi_card_smoke --part b     # one part
    python3 -m ray_tpu_torch.tools.multi_card_smoke --platform cpu --tiny

Fewer than four cards is an error: the script never runs on fewer ranks or
falls back to gloo. ``--platform cpu --tiny`` runs the same parts on gloo
groups of four CPU processes at ``LlamaConfig.tiny`` size (for the CPU tests
and for debugging before a card run); it measures no device metric.

Its first line names the cards (``nvidia-smi --query-gpu=name,power.limit``
for each), their links (``nvidia-smi topo -m`` and ``nvlink --status``
where the machine lets ``nvidia-smi`` read them; CUDA's peer access between
each pair) and torch's NCCL version; then one JSON line per reading; then
the first card's ``nvidia-smi`` line; the last line is ``{"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": 4}}``. A failed check fails its
part, and the run exits non-zero without the last line once every asked
part has run. Parts:

(a) the group of four: ``all_reduce``, ``all_gather_into_tensor`` and
    ``all_to_all_single`` on 1 GiB of bf16, timed with CUDA events beside
    the NVLink bound (450 GB/s each way a card), and NCCL's transport for
    each ordered pair of ranks (``NCCL_DEBUG=INFO``), once in a directly
    spawned group and once in ``TorchTrainer(num_workers=4)`` workers leased
    through the cluster's GPU id pool;
(b) the reference's 4-device step (``MeshSpec(seq=2, tensor=2)`` under
    ``tp_rules`` with ring attention, what ``dryrun_multichip(4)`` builds)
    and every other mesh at Llama-2-7B width (``CASES``): f32 parity (TF32
    off, 2 layers, 3 steps) against the one-card step on rank 0's card, then
    bf16 at 4 layers, step ms p50 over 10 steps after 2 warm-up steps,
    tokens/s a card, peak memory a card and flash launches a rank;
(c) ``TorchTrainer(num_workers=4)`` of ``tools/train_llama.py``'s loop
    (``TRAINER_RUNS``): ``ddp`` and ``tp`` at 4 layers in bf16 and ``tp`` at
    2 layers in f32, each against the one-card step on the same global
    batches, then Llama-2-7B at full depth under ``fsdp`` (8 steps, batch
    8 x 2048), its first loss against the one-card forward, its last step
    profiled on rank 0 (NCCL's kernels against the rest);
(d) the learner gang, update by update against one learner on the
    concatenated batch: ``IMPALA`` built with ``num_learners=4`` (its own
    ``LearnerGroup``) against ``num_learners=1``, both through
    ``IMPALA.learn``, then one ``IMPALA.train()`` of the gang with its env
    runners; and DQN on the Atari Q-net and PPO on a ``LearnerGroup`` this
    script builds around their update functions (neither algorithm runs a
    gang of its own), against one learner in this process; each gang's
    holds are emitted before its teardown, then the teardown's seconds
    (one ``LearnerGroup.shutdown`` deadline for the whole gang);
(e) full Llama-2-7B served by two replicas behind the router, one SIGKILLed
    mid-stream (f32, 2 layers, streams exact), and by disaggregated prefill
    and decode pools, each pool on its own card.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import re
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

from ray_tpu_torch.tools._smoke_common import (
    ROOT, SERVE_CLIENTS, SERVE_ENGINE, SERVE_NEW_TOKENS, SERVE_REQUESTS, HandleClient,
    bytecode_cache, nvidia_smi, quantiles, serve_traffic, stream_request,
)

T_START = time.perf_counter()
WORLD = 4
GROUP_TIMEOUT = timedelta(seconds=180)
#: the whole run's deadline: past it the script stops every process it
#: started and exits non-zero, so a hang ends the run, never the call
RUN_DEADLINE_S = 1380
#: NVLink between the cards of one H100 host: 450 GB/s each way a card
NVLINK_BYTES_PER_S = 450e9
#: peak dense bf16 rate of one H100 SXM (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
#: f32 parity bounds (``tests/test_torch_sharded_step.py``'s docstring)
LOSS_RTOL, GRAD_REL_NORM, PARAM_RTOL, LR = 2e-4, 1e-5, 2e-4, 1e-3
#: bf16 losses against the one-card step (``chip_smoke.py`` ``train`` (b))
BF16_RTOL = 2.0 ** -8
#: the learner gang against one learner: f32 stats relative, params in lr
RL_STATS_RTOL, RL_PARAMS_LR_FRACTION = 1e-4, 0.05
#: a learner gang's teardown: one ``LearnerGroup`` shutdown deadline (30 s
#: for the whole gang) and the kills after it
TEARDOWN_BOUND_S = 35.0
TIMED_STEPS, WARM_STEPS = 10, 2

#: (case, mesh axes, rules table, kind): the rules-constrained step on a
#: dense batch, the sequence-parallel impls over ``seq=4`` at the config's
#: max_seq_len, the 8-expert MoE, and GPipe against the layer loop
CASES = (
    ("seq2-tensor2-tp-ring", {"seq": 2, "tensor": 2}, "tp", "ring"),
    ("data4-ddp", {"data": 4}, "ddp", "dense"),
    ("fsdp4-fsdp", {"fsdp": 4}, "fsdp", "dense"),
    ("tensor4-tp", {"tensor": 4}, "tp", "dense"),
    ("data2-tensor2-tp", {"data": 2, "tensor": 2}, "tp", "dense"),
    ("seq4-tp-ring", {"seq": 4}, "tp", "seq_ring"),
    ("seq4-tp-ulysses", {"seq": 4}, "tp", "seq_ulysses"),
    ("expert4-tp-moe", {"expert": 4}, "tp", "moe"),
    ("stage4-gpipe", {"stage": 4}, None, "gpipe"),
)
#: part (c)'s trainer runs at 4 ranks, each against the one-card step:
#: (name, sharding, mesh axes, layers, dtype on the card; f32 on the CPU).
#: bf16 losses hold to BF16_RTOL, f32 ones to LOSS_RTOL: ``tp-f32``'s bound
#: is the one tight enough to see a gang step on rows other than the global
#: batch's (a tensor pair that does not gather its ranks' rows).
#: ``fsdp-7b``, Llama-2-7B at full depth under fsdp, comes after them.
TRAINER_RUNS = (
    ("ddp", "ddp", {"data": -1}, 4, "bfloat16"),
    ("tp", "tp", {"data": 2, "tensor": 2}, 4, "bfloat16"),
    ("tp-f32", "tp", {"data": 2, "tensor": 2}, 2, "float32"),
)
TRAINER_NAMES = tuple(r[0] for r in TRAINER_RUNS) + ("fsdp-7b",)
#: the one-card figures each case's step stands beside (``chip_smoke.py``
#: phases, H100 80GB HBM3 at 700 W, PERF.md)
ONE_CARD_MS = {"dense": "slice 78.8 ms at b=2, S=2048 (4 layers)",
               "ring": "ring on one card 271.9-277.6 ms", "seq_ring": "ring 271.9-277.6 ms",
               "seq_ulysses": "Ulysses 107.5-122.5 ms", "moe": "MoE step 351.5-353.7 ms",
               "gpipe": "slice 78.8 ms"}


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(f"multi_card_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# run settings


class Run:
    """What a run is: the platform (``cuda``: four cards, nccl; ``cpu``:
    four gloo processes), the size, where logs go, the cards' names."""

    def __init__(self, platform: str, tiny: bool, out: Path):
        self.platform, self.tiny, self.out = platform, tiny, out
        self.on_card = platform == "cuda"
        self.smi = None

    def job(self, **kw) -> dict:
        return {"platform": self.platform, "tiny": self.tiny, "out": str(self.out), **kw}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# spawned groups: this file run as each rank (``--worker KIND``)


def spawn_group(run: Run, kind: str, job: dict, timeout_s: float) -> list:
    """Start ``WORLD`` ranks of ``--worker kind``, wait for them, and return
    each rank's result (a pickle it writes). Any rank failing fails the
    group, with the ranks' log tails in the error."""
    d = run.out / kind
    d.mkdir(parents=True, exist_ok=True)
    for f in d.glob("*"):
        f.unlink()
    with open(d / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if run.on_card and kind == "collectives":
        env.update(NCCL_DEBUG="INFO", NCCL_DEBUG_FILE=str(d / "nccl.%h.%p.log"))
    elif not run.on_card:
        env.update(OMP_NUM_THREADS="1")
    port = free_port()
    logs = [open(d / f"rank{r}.log", "wb") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.tools.multi_card_smoke",
                               "--worker", kind, "--rank", str(r), "--port", str(port),
                               "--job", str(d / "job.pkl")],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * WORLD:
        tails = "\n".join(f"--- rank {r} ({codes[r]}) ---\n"
                          + (d / f"rank{r}.log").read_text(errors="replace")[-3000:]
                          for r in range(WORLD))
        raise CheckFailed(f"group {kind} exited {codes}:\n{tails}")
    out = []
    for r in range(WORLD):
        with open(d / f"result{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def join_group(job: dict, rank: int, port: int):
    """This rank's device and its place in the group of ``WORLD``."""
    import torch
    import torch.distributed as dist

    if job["platform"] == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        torch.set_num_threads(1)
        dev, backend = torch.device("cpu"), "gloo"
    # no device_id: each group's communicator starts at its first collective,
    # so a mesh's unused size-1 groups hold no NCCL buffers on the card
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD, timeout=GROUP_TIMEOUT)
    return dev


def worker_main(kind: str, rank: int, port: int, job_path: str) -> int:
    import torch.distributed as dist

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dev = join_group(job, rank, port)
    result = {"collectives": collectives, "mesh": mesh_cases}[kind](job, rank, dev)
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(job_path).parent / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    return 0


# ---------------------------------------------------------------------------
# (a) the group of four


def collectives(job: dict, rank: int, dev) -> dict:
    """All-reduce, all-gather and all-to-all on ``job["bytes"]`` a card over
    the default group: each checked once on values that show a misplaced
    chunk, then timed (CUDA events on the card)."""
    import torch
    import torch.distributed as dist

    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    numel = job["bytes"] // torch.empty((), dtype=dtype).element_size()
    numel -= numel % (WORLD * WORLD)
    n = WORLD
    x = torch.full((numel,), float(rank + 1), dtype=dtype, device=dev)
    dist.all_reduce(x)
    ok = {"all_reduce": bool((x == sum(range(1, n + 1))).all())}
    chunk = torch.full((numel // n,), float(rank + 1), dtype=dtype, device=dev)
    gathered = torch.empty(numel, dtype=dtype, device=dev)
    dist.all_gather_into_tensor(gathered, chunk)
    want = torch.arange(1, n + 1, dtype=dtype, device=dev).repeat_interleave(numel // n)
    ok["all_gather_into_tensor"] = bool(torch.equal(gathered, want))
    src = (rank * n + torch.arange(n, device=dev) + 1).to(dtype).repeat_interleave(numel // n)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src)
    want = (torch.arange(n, device=dev) * n + rank + 1).to(dtype).repeat_interleave(numel // n)
    ok["all_to_all_single"] = bool(torch.equal(dst, want))
    x.zero_()
    ops = {"all_reduce": lambda: dist.all_reduce(x),
           "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(gathered, chunk),
           "all_to_all_single": lambda: dist.all_to_all_single(dst, src)}
    ms = {}
    for name, op in ops.items():
        for _ in range(2):
            op()
        iters = job.get("iters", 5)
        dist.barrier()
        if on_card:
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                op()
            t1.record()
            torch.cuda.synchronize()
            ms[name] = t0.elapsed_time(t1) / iters
        else:
            t = time.perf_counter()
            for _ in range(iters):
                op()
            ms[name] = 1e3 * (time.perf_counter() - t) / iters
    nbytes = numel * x.element_size()
    return {"rank": rank, "device": str(dev), "bytes": nbytes, "dtype": str(dtype),
            "values_ok": ok, "ms": ms,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_name": torch.cuda.get_device_name(dev) if on_card else None}


def bus_readings(ms: dict, nbytes: int) -> dict:
    """nccl-tests' bus bandwidth of each op and its NVLink bound: an
    all-reduce moves 2(n-1)/n of the buffer each way a card, an all-gather
    and an all-to-all (n-1)/n."""
    n = WORLD
    factor = {"all_reduce": 2 * (n - 1) / n, "all_gather_into_tensor": (n - 1) / n,
              "all_to_all_single": (n - 1) / n}
    out = {}
    for op, t in ms.items():
        bound = factor[op] * nbytes / NVLINK_BYTES_PER_S * 1e3
        out[op] = {"ms": t, "bus_gb_per_s": factor[op] * nbytes / (t / 1e3) / 1e9,
                   "bound_ms": bound, "bound_share": bound / t}
    return out


_CHANNEL = re.compile(
    r"Channel \d+/\d+ : (\d+)\[[^\]]*\] -> (\d+)\[[^\]]*\](?: \[\w+\])? via (\S+)")


def nccl_transports(paths) -> dict:
    """From NCCL's INFO logs: the transports seen for each ordered pair of
    ranks (``"0->1": ["P2P/CUMEM/read"]``), the bootstrap interface lines,
    the NVLS and version lines."""
    pairs, notes = {}, set()
    for p in paths:
        for line in Path(p).read_text(errors="replace").splitlines():
            m = _CHANNEL.search(line)
            if m:
                pairs.setdefault(f"{m.group(1)}->{m.group(2)}", set()).add(m.group(3))
            elif "NCCL INFO" in line and any(k in line for k in (
                    "Bootstrap", "NET/", "NVLS", "NCCL version", "P2P plugin", "Using network",
                    "comm 0x")):
                notes.add(re.sub(r"^\S+:\d+:\d+ \[\d+\] ", "", line.strip())[:200])
    return {"pairs": {k: sorted(v) for k, v in sorted(pairs.items())},
            "notes": sorted(notes)[:40]}


def transports_check(what: str, tr: dict) -> bool:
    """Every ordered pair of the four ranks connected, each by P2P."""
    want = {f"{a}->{b}" for a in range(WORLD) for b in range(WORLD) if a != b}
    got = tr["pairs"]
    check(want <= set(got), f"{what}: NCCL connected every pair: {sorted(got)}")
    return all(all(t.startswith("P2P") for t in got[k]) for k in want)


def collective_loop(config: dict) -> None:
    """A ``TorchTrainer`` worker's half of part (a): the same collectives on
    the gang's process group, and what the worker sees; rank 0 reports
    every worker's readings."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train

    rank = train.get_context().get_world_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if config["platform"] == "cuda" \
        else torch.device("cpu")
    mine = collectives(config, rank, dev)
    mine.update(pid=os.getpid(), backend=dist.get_backend(), world_size=dist.get_world_size(),
                current_device=str(dev),
                mesh=dict(zip(train.get_mesh().mesh_dim_names, train.get_mesh().shape)))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        train.report({"workers": every})


def part_a(run: Run, cluster) -> None:
    nbytes = (4 << 20) if run.tiny or not run.on_card else (1 << 30)
    t0 = time.perf_counter()
    res = spawn_group(run, "collectives", run.job(bytes=nbytes), 300)
    spawned = {"phase": "a_group", "path": "spawned", "ranks": res,
               "seconds": time.perf_counter() - t0, "nvidia_smi": run.smi}
    spawned_ok = None
    if run.on_card:
        spawned["bus"] = bus_readings(res[0]["ms"], res[0]["bytes"])
        spawned["nccl"] = nccl_transports(sorted((run.out / "collectives").glob("nccl.*"))
                                          + sorted((run.out / "collectives").glob("rank*.log")))
    emit(spawned)
    for r in res:
        check(all(r["values_ok"].values()), f"spawned rank {r['rank']}: {r['values_ok']}")
    if run.on_card:
        check(sorted(r["device"] for r in res) == [f"cuda:{i}" for i in range(WORLD)],
              "each spawned rank sets its own card")
        spawned_ok = transports_check("spawned group", spawned["nccl"])

    # the same through TorchTrainer workers leased from the GPU id pool
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.tools import multi_card_smoke as me
    from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig, TorchTrainer

    ndir = run.out / "trainer_nccl"
    ndir.mkdir(parents=True, exist_ok=True)
    for f in ndir.glob("*"):
        f.unlink()
    env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_FILE": str(ndir / "nccl.%h.%p.log")} \
        if run.on_card else {}
    t0 = time.perf_counter()
    result = TorchTrainer(
        me.collective_loop, train_loop_config={"bytes": nbytes, "platform": run.platform},
        scaling_config=ScalingConfig(num_workers=WORLD, use_gpu=run.on_card),
        backend_config=TorchBackendConfig(platform=None if run.on_card else "cpu",
                                          extra_env=env, mesh_spec=MeshSpec(data=-1),
                                          sharding="ddp",
                                          timeout_s=GROUP_TIMEOUT.total_seconds())).fit()
    workers = result.metrics["workers"]
    gang = {"phase": "a_group", "path": "TorchTrainer", "workers": workers,
            "cluster_gpus": cluster["gpus"], "fit_s": time.perf_counter() - t0,
            "nvidia_smi": run.smi}
    if run.on_card:
        gang["bus"] = bus_readings(workers[0]["ms"], workers[0]["bytes"])
        gang["nccl"] = nccl_transports(sorted(ndir.glob("nccl.*")))
        gang["spawned_all_p2p"] = spawned_ok
    emit(gang)
    for w in workers:
        check(all(w["values_ok"].values()), f"trainer worker {w['rank']}: {w['values_ok']}")
        check(w["world_size"] == WORLD and w["backend"] == ("nccl" if run.on_card else "gloo"),
              f"trainer worker's group: {w}")
    if run.on_card:
        leased = [w["cuda_visible_devices"] for w in workers]
        check(sorted(leased) == sorted(set(leased)) and len(set(leased)) == WORLD
              and "" not in leased, f"each worker leased its own card: {leased}")
        gang_ok = transports_check("trainer gang", gang["nccl"])
        check(gang_ok or not spawned_ok,
              "the trainer's one-visible-GPU workers reach each other as the spawned group does")
        check(spawned_ok, "P2P between every pair of ranks")


# ---------------------------------------------------------------------------
# (b) meshes at 7B width


def case_config(job: dict, kind: str, dtype, n_layers: int):
    from ray_tpu_torch.models import llama as L

    kw = dict(n_layers=n_layers, dtype=dtype)
    if kind in ("ring", "seq_ring"):
        kw["attention_impl"] = "ring"
    elif kind == "seq_ulysses":
        kw["attention_impl"] = "ulysses"
    elif kind == "moe":
        kw.update(moe_experts=4, moe_capacity_factor=0.5) if job["tiny"] else \
            kw.update(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
    return L.LlamaConfig.tiny(**kw) if job["tiny"] else L.LlamaConfig.llama2_7b(**kw)


def case_batch(job: dict, kind: str, timing: bool):
    """(rows, seq) of the case's global batch: ``max_seq_len`` over
    ``seq=4``, else 2048 tokens (16 tiny) in 4 rows for parity and 8 for
    timing (2 a card where the batch shards), MoE at the one-card MoE
    step's 2 rows."""
    if job["tiny"]:
        return (2, 32) if kind.startswith("seq") else (4, 16)
    if kind.startswith("seq"):
        return 2, 4096
    if kind == "moe":
        return 2, 2048
    return (8 if timing else 4), 2048


def make_batch(rows: int, seq: int, vocab: int, seed: int, dev):
    import numpy as np
    import torch

    toks = np.random.RandomState(seed).randint(0, vocab, size=(rows, seq + 1))
    t = torch.from_numpy(toks).to(dev)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


def _gather_compare(local_tree: dict, ref: dict, rank: int, fn) -> float:
    """Worst ``fn(full, ref)`` over the leaves: each DTensor leaf gathered on
    every rank (a collective), compared on rank 0 only."""
    from torch.distributed.tensor import DTensor

    worst = 0.0
    for name, t in local_tree.items():
        full = t.full_tensor() if isinstance(t, DTensor) else t
        if rank == 0:
            worst = max(worst, fn(full.detach().float(), ref[name].to(full.device).float()))
        del full
    return worst


def _rel_norm(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _param_ratio(a, b) -> float:
    """Largest ``|a - b| / (LR + rtol |b|)``: at most 1 within bounds."""
    return float(((a - b).abs() / (LR + PARAM_RTOL * b.abs())).max())


def _free(torch):
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_step(cfg, batch, dev) -> dict:
    """The port's one-card step (no mesh) from ``init_params(cfg, 0)``: the
    first step's gradients, 3 steps' losses and the params after them, on
    the host."""
    import torch

    from ray_tpu_torch.models import llama as L

    model = L.init_params(cfg, 0, device=dev)
    L.next_token_loss(cfg, model, batch["tokens"], batch["targets"]).backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    state = (model, L.adamw(LR)(model.parameters()))
    step = L.make_train_step(cfg)
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del state, model
    _free(torch)
    return {"losses": losses, "grads": grads, "params": params}


def mesh_parity(job, rank, dev, mesh, table, kind, refs) -> dict:
    """3 selective-remat steps of the rules-constrained step in f32 on the
    case's mesh, against the one-card step (rank 0 computes it, once per
    config and batch)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.parallel import sharding as S

    n_layers = 2
    cfg = case_config(job, kind, torch.float32, n_layers)
    rows, seq = case_batch(job, kind, timing=False)
    batch = make_batch(rows, seq, cfg.vocab_size, 5, dev)
    key = (kind == "moe", rows, seq)
    if rank == 0 and key not in refs:
        plain = case_config(job, "moe" if kind == "moe" else "dense", torch.float32, n_layers)
        refs[key] = reference_step(plain, batch, dev)
    dist.barrier()
    ref = refs.get(key)
    rules = getattr(S, f"{table}_rules")()
    model = L.init_sharded(cfg, mesh, rules, 0)
    loss = L.next_token_loss(cfg, model, batch["tokens"], batch["targets"], remat="selective",
                             mesh=mesh, rules=rules)
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    grads = S.constrain_tree(dict(zip(names, torch.autograd.grad(loss, list(model.parameters())))),
                             mesh, L.partition_rules(cfg, rules))
    grads = {n.replace("/", "."): g for n, g in grads.items()}
    grad_err = _gather_compare(grads, ref["grads"] if ref else {}, rank, _rel_norm)
    del grads, loss
    state = (model, L.adamw(LR)(model.parameters()))
    step = L.make_train_step(cfg, remat="selective", mesh=mesh, rules=rules)
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    param_ratio = _gather_compare(dict(model.named_parameters()),
                                  ref["params"] if ref else {}, rank, _param_ratio)
    placements = sorted({str(tuple(p.placements)) for p in model.parameters()})
    del state, model
    _free(torch)
    out = {"losses": losses, "batch": [rows, seq], "n_layers": n_layers,
           "placements": placements}
    if rank == 0:
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        out.update(reference_losses=ref["losses"], loss_max_rel=loss_rel,
                   grad_max_rel_norm=grad_err, param_max_ratio=param_ratio,
                   ok=loss_rel <= LOSS_RTOL and grad_err <= GRAD_REL_NORM
                   and param_ratio <= 1.0 and losses[-1] < losses[0])
    return out


def gpipe_stage_fn(L, cfg, cos, sin):
    import types

    def layer(p, x):
        x = L._attention_block(cfg, p, x, cos, sin)
        return L._mlp_block(cfg, p, x)[0]

    def stage_fn(p, x):
        for lp in p["layers"]:
            x = layer(types.SimpleNamespace(**lp), x)
        return x

    return layer, stage_fn


def gpipe_run(job, rank, dev, mesh, dtype, n_layers, rows, seq, timed: bool):
    """``pipeline_apply`` over ``stage=4``, one layer a card, 4 microbatches,
    forward and backward (a seeded cotangent); rank 0 also runs the layer
    loop on the same microbatches. Returns the readings."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    cfg = case_config(job, "dense", dtype, n_layers)
    model = L.init_params(cfg, 0, device=dev)
    names = list(L._layer_shapes(cfg))
    batch = make_batch(rows, seq, cfg.vocab_size, 5, dev)
    with torch.no_grad():
        x = torch.nn.functional.embedding(batch["tokens"], model.embed)
    cos, sin = L.rope_tables(cfg, seq, device=dev)
    layer, stage_fn = gpipe_stage_fn(L, cfg, cos, sin)
    per_stage = n_layers // WORLD
    stacked = stack_stage_params([
        {"layers": [{k: getattr(lp, k).detach() for k in names}
                    for lp in model.layers[s * per_stage:(s + 1) * per_stage]]}
        for s in range(WORLD)])
    leaves = [lp[k].requires_grad_() for lp in stacked["layers"] for k in names]
    micro = x.reshape(WORLD, rows // WORLD, seq, cfg.dim)
    g = torch.Generator(device=dev).manual_seed(9)
    cot = torch.randn(micro.shape, generator=g, device=dev, dtype=micro.dtype)

    def once():
        for t in leaves:
            t.grad = None
        y = pipeline_apply(mesh, stage_fn, stacked, micro)
        y.backward(cot)
        return y.detach()

    out = {}
    if timed:
        from ray_tpu_torch.ops import attention as A

        for _ in range(WARM_STEPS):
            once()
        A.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(TIMED_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            once()
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        out.update(step_ms=ms, launches=_launches(A, TIMED_STEPS))
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated() \
            if dev.type == "cuda" else None
    else:
        y = once()
        grads = [t.grad for t in leaves]
        if rank == 0:
            ly = torch.stack([_loop(layer, model.layers, m) for m in micro])
            ly.backward(cot)
            lg = [getattr(lp, k).grad for lp in model.layers for k in names]
            # stacked leaf (stage s, layer j, name k) holds layer s*per+j's grad
            rel = [_rel_norm(grads[i][s].float(), lg[(s * per_stage) * len(names) + i].float())
                   for s in range(WORLD) for i in range(len(names))] if per_stage == 1 else []
            out.update(forward_rel_rms=float(((y - ly.detach()).float().pow(2).mean()
                                              / ly.detach().float().pow(2).mean()).sqrt()),
                       forward_equal=bool(torch.equal(y, ly.detach())),
                       grad_max_rel_norm=max(rel))
            out["ok"] = out["forward_rel_rms"] <= GRAD_REL_NORM and \
                out["grad_max_rel_norm"] <= GRAD_REL_NORM
    del stacked, leaves, model
    dist.barrier()
    _free(torch)
    return out


def _loop(layer, layers, x):
    for lp in layers:
        x = layer(lp, x)
    return x


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _launches(A, steps: int) -> dict:
    return {fn.__name__: {"launches": fn.launches, "per_step": fn.launches / steps,
                          "by_route": dict(fn.route_launches)} for fn in A.KERNELS}


def mesh_timing(job, rank, dev, mesh, table, kind) -> dict:
    """bf16 at 4 layers: 2 warm-up steps, then 10 timed (host clock to a
    device sync), the peak memory and this rank's flash launches."""
    import torch

    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel import sharding as S

    cfg = case_config(job, kind, torch.bfloat16, 4)
    rows, seq = case_batch(job, kind, timing=True)
    batch = make_batch(rows, seq, cfg.vocab_size, 6, dev)
    rules = getattr(S, f"{table}_rules")()
    state = L.init_sharded(cfg, mesh, rules, 0, L.adamw(1e-4))
    step = L.make_train_step(cfg, remat="selective", mesh=mesh, rules=rules)
    for _ in range(WARM_STEPS):
        state, loss = step(state, batch)
    A.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(TIMED_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    out = {"step_ms": ms, "losses": losses, "launches": _launches(A, TIMED_STEPS),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "batch": [rows, seq], "params": L.param_count(cfg)}
    del state
    _free(torch)
    return out


def mesh_cases(job: dict, rank: int, dev) -> dict:
    """Every asked case: f32 parity, then (on the card) bf16 timing. Rank 0
    writes each case's readings as it finishes them."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ray_tpu_torch.parallel import mesh as M

    refs: dict = {}
    lines = []
    for name, axes, table, kind in CASES:
        if name not in job["cases"]:
            continue
        t0 = time.perf_counter()
        # one mesh a case: each mesh adds its own groups (communicators)
        mesh = M.make_mesh(M.MeshSpec(**axes), dev.type)
        if kind == "gpipe":
            rows, seq = case_batch(job, "dense", timing=False)
            parity = gpipe_run(job, rank, dev, mesh, torch.float32, WORLD, rows, seq, timed=False)
        else:
            parity = mesh_parity(job, rank, dev, mesh, table, kind, refs)
        reading = {"case": name, "mesh": axes, "rules": table, "kind": kind,
                   "f32": parity, "f32_seconds": time.perf_counter() - t0}
        if dev.type == "cuda":
            t0 = time.perf_counter()
            if kind == "gpipe":
                rows, seq = case_batch(job, "dense", timing=True)
                timing = gpipe_run(job, rank, dev, mesh, torch.bfloat16, WORLD, rows, seq,
                                   timed=True)
                timing["batch"] = [rows, seq]
            else:
                timing = mesh_timing(job, rank, dev, mesh, table, kind)
            every = [None] * WORLD
            dist.all_gather_object(every, {"max_memory_allocated_bytes":
                                           timing["max_memory_allocated_bytes"],
                                           "launches": timing["launches"]})
            p50 = float(sorted(timing["step_ms"])[len(timing["step_ms"]) // 2])
            rows, seq = timing["batch"]
            reading["bf16"] = {**timing, "step_ms_p50": p50,
                               "tokens_per_s_per_card": rows * seq / (p50 / 1e3) / WORLD,
                               "per_rank": every, "one_card": ONE_CARD_MS[kind],
                               "seconds": time.perf_counter() - t0}
        if rank == 0:
            lines.append(reading)
            with open(Path(job["out"]) / "mesh" / "readings.jsonl", "a") as f:
                f.write(json.dumps(reading, default=str) + "\n")
        dist.barrier()
    return lines


def part_b(run: Run, cases) -> None:
    t0 = time.perf_counter()
    res = spawn_group(run, "mesh", run.job(cases=list(cases)), 900 if run.on_card else 600)
    failed = []
    for reading in res[0]:
        reading.update(phase="b_mesh", nvidia_smi=run.smi)
        emit(reading)
        if not reading["f32"].get("ok"):
            failed.append(reading["case"])
        launches = reading.get("bf16", {}).get("launches")
        if launches is not None:
            want = 0 if reading["kind"] in ("ring", "seq_ring") else 4
            per_step = {k: v["per_step"] for k, v in launches.items()}
            if reading["kind"] == "gpipe":
                want = 2 * WORLD - 1  # one layer a rank, every step of M + S - 1
            if per_step != {k: want for k in per_step} or any(
                    v["by_route"].get("cuda_core") for v in launches.values()):
                failed.append(f"{reading['case']} launches {launches}")
    emit({"phase": "b_mesh", "part": "end", "cases": len(res[0]), "failed": failed,
          "seconds": time.perf_counter() - t0})
    check(len(res[0]) == len(cases), f"every case ran: {len(res[0])} of {len(cases)}")
    check(not failed, f"every case holds its bounds: {failed}")


# ---------------------------------------------------------------------------
# (c) TorchTrainer over four GPU workers


def gang_train_loop(config: dict) -> None:
    """``llama_train_loop`` with what the gang is around it: before, each
    worker's devices, group and mesh and the first global batch (every
    rank's first rows, in rank order); after, each worker's peak memory and
    flash launches. Rank 0 reports both."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.tools.train_llama import llama_train_loop

    on_card = config.get("platform") == "cuda"
    rank = train.get_context().get_world_rank()
    mesh = train.get_mesh()
    first = next(iter(train.get_dataset_shard("train").iter_batches(
        batch_size=config["batch_size"])))["value"]
    mine = {"rank": rank, "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": f"cuda:{torch.cuda.current_device()}" if on_card else "cpu",
            "device_count": torch.cuda.device_count() if on_card else 0,
            "device_name": torch.cuda.get_device_name() if on_card else None,
            "backend": dist.get_backend(), "world_size": dist.get_world_size(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "first_rows": np.asarray(first).tolist()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        train.report({"gang": every})
    llama_train_loop(config)
    after = {"rank": rank,
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_card else None,
             "launches": {fn.__name__: fn.launches for fn in A.KERNELS},
             "launches_by_route": {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS}}
    dist.all_gather_object(every, after)
    if rank == 0:
        train.report({"after": every})


def trainer_fit(run: Run, loop_config: dict, rows, mesh_spec, sharding: str):
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.tools import multi_card_smoke as me
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    return TorchTrainer(
        me.gang_train_loop, train_loop_config={**loop_config, "platform": run.platform},
        scaling_config=ScalingConfig(num_workers=WORLD, use_gpu=run.on_card),
        backend_config=TorchBackendConfig(platform=None if run.on_card else "cpu",
                                          mesh_spec=mesh_spec, sharding=sharding,
                                          timeout_s=GROUP_TIMEOUT.total_seconds()),
        run_config=RunConfig(name=f"mc_{sharding}", storage_path=str(run.out / "train")),
        datasets={"train": rd.from_numpy(rows, block_size=loop_config["batch_size"])}).fit()


def gang_checks(run: Run, what: str, history, rows, per_rank: int) -> tuple:
    """The gang's readings from rank 0's reports: workers, losses, step ms."""
    import numpy as np

    gang = next(m["gang"] for m in history if "gang" in m)
    after = next(m["after"] for m in history if "after" in m)
    done = next(m for m in history if m.get("done"))
    steps = [m for m in history if "loss" in m]
    first = np.concatenate([np.asarray(w["first_rows"]) for w in gang])
    check(np.array_equal(first, rows[:WORLD * per_rank]),
          f"{what}: the first global batch is every rank's rows in rank order")
    for w in gang:
        check(w["world_size"] == WORLD and w["backend"] == ("nccl" if run.on_card else "gloo"),
              f"{what}: worker {w['rank']}'s group {w}")
    if run.on_card:
        leased = [w["cuda_visible_devices"] for w in gang]
        check(len(set(leased)) == WORLD and "" not in leased and
              all(w["device_count"] == 1 for w in gang),
              f"{what}: each worker leased a card of its own: {leased}")
    for w in gang:
        w.pop("first_rows")
    return gang, after, done, steps


def one_card_losses(cfg, rows, per_step: int, steps: int, dev) -> list:
    """The port's plain step on one device over the gang's global batches."""
    import torch

    from ray_tpu_torch.models import llama as L

    model = L.init_params(cfg, 0, device=dev)
    state = (model, L.adamw(1e-4)(model.parameters()))
    step = L.make_train_step(cfg)
    out = []
    for i in range(steps):
        t = torch.from_numpy(rows[i * per_step:(i + 1) * per_step]).to(dev)
        state, loss = step(state, {"tokens": t[:, :-1], "targets": t[:, 1:]})
        out.append(float(loss))
    del state, model
    _free(torch)
    return out


def part_c(run: Run, cluster, names) -> None:
    """The trainer runs of ``TRAINER_RUNS`` named in ``names``, each against
    the one-card step on the same global batches, then (``fsdp-7b``)
    Llama-2-7B at full depth under fsdp."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.parallel.mesh import MeshSpec

    dev = torch.device("cuda", 0) if run.on_card else torch.device("cpu")
    tiny = run.tiny
    seq, per_rank = (16, 2) if tiny else (2048, 2)
    per_step = WORLD * per_rank
    steps = 4
    for name, sharding, axes, n_layers, dtype in TRAINER_RUNS:
        if name not in names:
            continue
        dtype = "float32" if tiny else dtype
        rows = np.random.RandomState(21).randint(0, 32000 if not tiny else 256,
                                                 size=(steps * per_step, seq + 1))
        rows[per_step:] = np.tile(rows[:per_step], (steps - 1, 1))
        model = {"preset": "tiny" if tiny else "llama2_7b", "n_layers": n_layers, "dtype": dtype}
        loop = {"model": model, "seed": 0, "lr": 1e-4, "remat": "selective",
                "batch_size": per_rank}
        t0 = time.perf_counter()
        result = trainer_fit(run, loop, rows, MeshSpec(**axes), sharding)
        fit_s = time.perf_counter() - t0
        gang, after, done, hist = gang_checks(run, f"trainer {name}", result.metrics_history,
                                              rows, per_rank)
        losses = [m["loss"] for m in hist]
        preset = L.LlamaConfig.tiny if tiny else L.LlamaConfig.llama2_7b
        ref = one_card_losses(preset(n_layers=n_layers, dtype=getattr(torch, dtype)), rows,
                              per_step, steps, dev)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        tol = LOSS_RTOL if dtype == "float32" else BF16_RTOL
        ms = [m["step_ms"] for m in hist[1:]]
        emit({"phase": "c_trainer", "run": name, "sharding": sharding, "mesh": done["mesh"],
              "config": f"{model['preset']}(n_layers={n_layers}) {dtype}",
              "batch": [per_step, seq], "workers": gang, "after": after, "losses": losses,
              "one_card_losses": ref, "max_rel_diff": rel, "tol": tol,
              "step_ms_each": [m["step_ms"] for m in hist],
              "step_ms_p50": quantiles(ms).get("p50"), "fit_s": fit_s, "nvidia_smi": run.smi})
        check(len(losses) == steps and rel <= tol,
              f"trainer {name}: losses {losses} against one card {ref}: {rel}")
    if "fsdp-7b" not in names:
        return
    # Llama-2-7B at full depth under fsdp
    cfg = L.LlamaConfig.tiny(dtype=torch.float32) if tiny else L.LlamaConfig.llama2_7b()
    steps = 8
    # one global batch, every step (as ``chip_smoke.py`` ``slice``): the loss falls
    rows = np.tile(np.random.RandomState(22).randint(0, cfg.vocab_size, size=(per_step, seq + 1)),
                   (steps, 1))
    t0 = time.perf_counter()
    model = L.init_params(cfg, 0, device=dev)
    with torch.no_grad():
        t = torch.from_numpy(rows[:per_step]).to(dev)
        fwd_loss = float(L.next_token_loss(cfg, model, t[:, :-1], t[:, 1:]))
    del model, t
    _free(torch)
    fwd_s = time.perf_counter() - t0
    # the gang trains in the dtype of the one-card forward's config
    dtype = str(cfg.dtype).removeprefix("torch.")
    preset = {"preset": "tiny" if tiny else "llama2_7b", "dtype": dtype}
    loop = {"model": preset, "seed": 0, "lr": 1e-4, "remat": "selective",
            "batch_size": per_rank, "profile_step": steps - 1}
    t0 = time.perf_counter()
    result = trainer_fit(run, loop, rows, MeshSpec(fsdp=-1), "fsdp")
    fit_s = time.perf_counter() - t0
    gang, after, done, hist = gang_checks(run, "trainer fsdp (full depth)",
                                          result.metrics_history, rows, per_rank)
    losses = [m["loss"] for m in hist]
    ms = [m["step_ms"] for m in hist[1:steps - 1]]
    p50 = quantiles(ms).get("p50")
    n_params = L.param_count(cfg)
    tokens = per_step * seq
    # 6 N per token, and attention's QK^T and PV: 12 * layers * dim * seq
    # per token (causal: half of it), forward and backward
    flops = 6 * n_params * tokens + 6 * cfg.n_layers * cfg.dim * seq * tokens
    profile = next((m["profile"] for m in hist if "profile" in m), None)
    reading = {"phase": "c_trainer", "run": "fsdp-7b", "sharding": "fsdp",
               "config": f"{preset['preset']} full depth {dtype}", "params": n_params,
               "mesh": done["mesh"], "batch": [per_step, seq], "remat": "selective",
               "workers": gang, "after": after, "losses": losses,
               "one_card_forward_loss": fwd_loss, "one_card_forward_s": fwd_s,
               "first_loss_rel_diff": abs(losses[0] - fwd_loss) / abs(fwd_loss),
               "step_ms_each": [m["step_ms"] for m in hist], "step_ms_p50": p50,
               "tokens_per_s": tokens / (p50 / 1e3) if p50 else None,
               "rank0_profile_of_step": steps - 1, "profile": profile,
               "fit_s": fit_s, "nvidia_smi": run.smi}
    if run.on_card:
        reading["flops_per_step"] = flops
        reading["mfu"] = flops / (p50 / 1e3) / (WORLD * PEAK_BF16_FLOPS)
        reading["peak_bytes_per_card"] = [w["max_memory_allocated_bytes"] for w in after]
    emit(reading)
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"fsdp: 8 finite losses {losses}")
    check(losses[-1] < losses[0], f"fsdp: the loss falls {losses}")
    check(reading["first_loss_rel_diff"] <= (LOSS_RTOL if tiny else BF16_RTOL),
          f"fsdp: the first loss {losses[0]} against the one-card forward {fwd_loss}")


# ---------------------------------------------------------------------------
# (d) the learner gang


def _dqn_batch(n: int, seed: int, tiny: bool):
    import numpy as np

    rs = np.random.RandomState(seed)
    shape = (8, 8, 4) if tiny else (84, 84, 4)
    return {"obs": rs.randint(0, 256, (n, *shape)).astype(np.uint8),
            "actions": rs.randint(0, 6, n).astype(np.int64),
            "rewards": rs.randn(n).astype(np.float32),
            "next_obs": rs.randint(0, 256, (n, *shape)).astype(np.uint8),
            "dones": (rs.rand(n) < 0.1)}


def _ppo_batch(n: int, seed: int):
    import numpy as np

    rs = np.random.RandomState(seed)
    return {"obs": rs.randn(n, 4).astype(np.float32),
            "actions": rs.randint(0, 2, n).astype(np.int64),
            "logp_old": (np.log(0.5) + 0.1 * rs.randn(n)).astype(np.float32),
            "advantages": rs.randn(n).astype(np.float32),
            "returns": rs.randn(n).astype(np.float32)}


class _MeanStep:
    """An optimizer whose ``step`` first averages the gradients over the
    gang (the ``LearnerGroup`` update contract), so the algorithms' own
    update functions run unchanged."""

    def __init__(self, opt, mean_grads):
        self.opt, self.mean_grads = opt, mean_grads

    def zero_grad(self, set_to_none: bool = True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.mean_grads([p.grad for g in self.opt.param_groups for p in g["params"]])
        self.opt.step()


def rl_init(tiny: bool):
    """A learner's state: the DQN Q-net (Atari's conv stack, 8x8x4 frames
    tiny), its target and Adam, and the PPO policy and its Adam, from the
    algorithms' seeds; cuDNN's deterministic algorithms (its default
    backward-filter sums with atomics)."""

    def init(device):
        import torch

        from ray_tpu_torch.rl import dqn as D
        from ray_tpu_torch.rl import ppo as P
        from ray_tpu_torch.rl.models import init_cnn, init_mlp_policy
        from ray_tpu_torch.rl.utils import adam, clone_params, on_device

        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        dcfg, pcfg = D.DQNConfig(model="cnn_q"), P.PPOConfig()
        shape = (8, 8, 4) if tiny else (84, 84, 4)
        q = on_device(init_cnn(torch.Generator().manual_seed(dcfg.seed), shape, 6,
                               heads=("q",)), device)
        pi = on_device(init_mlp_policy(torch.Generator().manual_seed(pcfg.seed), 4, 2,
                                       pcfg.hidden), device)
        return ({"dqn": q, "ppo": pi}, clone_params(q), adam(q, dcfg.lr), adam(pi, pcfg.lr))

    return init


def rl_update_builder():
    """The update of a gang this script builds (DQN and PPO run no
    ``LearnerGroup`` of their own): DQN's for a replay batch (it has
    ``next_obs``), PPO's otherwise, each the algorithm's own update
    function, its optimizer step wrapped to average the gradients first."""
    import types

    import torch

    from ray_tpu_torch.rl import dqn as D
    from ray_tpu_torch.rl import ppo as P

    shim = types.SimpleNamespace(config=D.DQNConfig(model="cnn_q"))
    shim._apply = types.MethodType(D.DQN._apply, shim)
    dqn = D.DQN._make_update(shim)
    ppo = P.PPO._make_update(types.SimpleNamespace(config=P.PPOConfig()))

    def gang_update(state, batch, mean_grads):
        params, target, q_opt, pi_opt = state
        if "next_obs" in batch:
            stats = dqn(params["dqn"], target, _MeanStep(q_opt, mean_grads), batch)
        else:
            stats = ppo(params["ppo"], _MeanStep(pi_opt, mean_grads), batch)
        return state, {k: torch.as_tensor(v) for k, v in stats.items()}

    return gang_update


def _impala_batch(n: int, t: int, seed: int):
    """A batch-major V-trace batch of ``n`` CartPole envs x ``t`` steps (the
    arrays ``IMPALA._to_batch`` makes of a rollout)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    return {"obs": rs.randn(n, t, 4).astype(np.float32),
            "actions": rs.randint(0, 2, (n, t)).astype(np.int32),
            "behavior_logp": (np.log(0.5) + 0.1 * rs.randn(n, t)).astype(np.float32),
            "rewards": np.ones((n, t), np.float32),
            "dones": (rs.rand(n, t) < 0.05).astype(np.float32),
            "bootstrap": rs.randn(n).astype(np.float32)}


class CartPoleSpec:
    """CartPole's spaces and nothing else: what ``IMPALA`` probes of its env
    (``env="ray_tpu_torch.tools.multi_card_smoke:CartPoleSpec"``) where
    ``gymnasium``, which steps the env runners, is not installed (the
    cards' machine)."""

    observation_space = SimpleNamespace(shape=(4,))
    action_space = SimpleNamespace(n=2)

    def close(self) -> None:
        pass


def impala_gang(run: Run) -> tuple:
    """IMPALA through its own entry point: ``IMPALAConfig(num_learners=4)
    .build()`` runs its V-trace update on a ``LearnerGroup`` of four; held
    update by update (as ``part_d``) against ``num_learners=1``, whose
    learner lives in this process, both through ``IMPALA.learn`` on the
    same batches; then, where ``gymnasium`` is installed, one ``train()``
    of the gang, its CartPole env runners sampling (without it, the env is
    ``CartPoleSpec`` and there are no runners). Returns the gang's learners
    and the failed holds."""
    import importlib.util

    import numpy as np

    from ray_tpu_torch.rl.impala import IMPALAConfig
    from ray_tpu_torch.rl.models import tree_leaves

    platform = None if run.on_card else "cpu"
    gym = importlib.util.find_spec("gymnasium") is not None
    env = {} if gym else {"env": "ray_tpu_torch.tools.multi_card_smoke:CartPoleSpec",
                          "num_env_runners": 0}
    t0 = time.perf_counter()
    gang = IMPALAConfig(num_learners=WORLD, learner_platform=platform,
                        learner_timeout_s=GROUP_TIMEOUT.total_seconds(), **env).build()
    start_s = time.perf_counter() - t0
    one = IMPALAConfig(num_learners=1, learner_platform=platform, **env).build()
    rows, update_s = [], []
    try:
        for i in range(4):
            b = _impala_batch(16, 64, 50 + i)
            t1 = time.perf_counter()
            state = gang.get_state()
            t2 = time.perf_counter()
            one.set_state(state)
            ref = one.learn(b)
            t3 = time.perf_counter()
            got = gang.learn(b)
            t4 = time.perf_counter()
            after = gang.get_state()
            update_s.append(t4 - t3)
            diff = max(float(np.max(np.abs(x - y))) for x, y in zip(
                tree_leaves(after["state"][0]), tree_leaves(one.get_state()["state"][0])))
            rows.append({"stats": got, "one_learner_stats": ref,
                         "stats_max_rel_diff": max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                                                   for k in ref),
                         "params_max_abs_diff_over_lr": diff / gang.config.lr,
                         "seconds": {"get_state": t2 - t1, "one_learner": t3 - t2,
                                     "get_state_after": time.perf_counter() - t4}})
        trained = gang.train() if gym else None
        learners = gang._group.learner_info
        worst = {k: max(r[k] for r in rows)
                 for k in ("stats_max_rel_diff", "params_max_abs_diff_over_lr")}
        emit({"phase": "d_learners", "algo": "impala",
              "entry": "IMPALAConfig(num_learners=4).build()",
              "updates": rows, "global_batch": [16, 64], **worst,
              "tol": {"stats_rtol": RL_STATS_RTOL, "params_lr_fraction": RL_PARAMS_LR_FRACTION},
              "gang_update_s": update_s, "start_s": start_s, "env": gang.config.env,
              "train": trained, "learners": learners, "nvidia_smi": run.smi})
    finally:
        teardown_s = _teardown("impala", gang.stop, run)
        one.stop()
    failed = []
    if worst["stats_max_rel_diff"] > RL_STATS_RTOL or \
            worst["params_max_abs_diff_over_lr"] > RL_PARAMS_LR_FRACTION:
        failed.append(("impala", worst))
    if gym and not (trained["num_env_steps_trained"] > 0 and
            all(math.isfinite(trained[k]) for k in ("loss", "pi_loss", "vf_loss", "entropy"))):
        failed.append(("impala train()", trained))
    if teardown_s > TEARDOWN_BOUND_S:
        failed.append(("impala teardown_s", teardown_s))
    return learners, failed


def _teardown(gang: str, stop, run: Run) -> float:
    """Runs ``stop`` (the gang's teardown) and emits how long it took."""
    t0 = time.perf_counter()
    stop()
    teardown_s = time.perf_counter() - t0
    emit({"phase": "d_learners", "part": "teardown", "gang": gang, "teardown_s": teardown_s,
          "bound_s": TEARDOWN_BOUND_S, "nvidia_smi": run.smi})
    return teardown_s


def built_gang(run: Run) -> tuple:
    """DQN and PPO on a ``LearnerGroup`` this script builds around their
    update functions (``rl_update_builder``), held update by update
    against one learner in this process on the same update function.
    Returns the gang's learners and the failed holds."""
    import numpy as np
    import torch

    from ray_tpu_torch.rl import dqn as D
    from ray_tpu_torch.rl import ppo as P
    from ray_tpu_torch.rl.learner_group import LearnerGroup
    from ray_tpu_torch.rl.models import to_host, tree_leaves
    from ray_tpu_torch.rl.utils import load_state_
    from ray_tpu_torch.tools import multi_card_smoke as me

    batches = {"dqn": [_dqn_batch(256, 30 + i, run.tiny) for i in range(4)],
               "ppo": [_ppo_batch(512, 40 + i) for i in range(4)]}
    lrs = {"dqn": D.DQNConfig().lr, "ppo": P.PPOConfig().lr}
    dev = torch.device("cuda", 0) if run.on_card else torch.device("cpu")
    one = me.rl_init(run.tiny)(dev)
    one_update = me.rl_update_builder()
    t0 = time.perf_counter()
    group = LearnerGroup(num_learners=WORLD, init_fn=me.rl_init(run.tiny),
                         update_builder=me.rl_update_builder,
                         platform=None if run.on_card else "cpu",
                         timeout_s=GROUP_TIMEOUT.total_seconds())
    failed = []
    try:
        start_s = time.perf_counter() - t0
        for algo, bs in batches.items():
            rows, update_s = [], []
            for b in bs:
                load_state_(one, group.get_state())
                tb = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in b.items()}
                one, ref = one_update(one, tb, lambda grads: None)
                ref = {k: float(v) for k, v in ref.items()}
                t1 = time.perf_counter()
                got = group.update(b)
                update_s.append(time.perf_counter() - t1)
                diff = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y)))) for x, y in zip(
                    tree_leaves(group.get_params()[algo]), tree_leaves(to_host(one[0])[algo])))
                rows.append({"stats": got, "one_learner_stats": ref,
                             "stats_max_rel_diff": max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                                                       for k in ref),
                             "params_max_abs_diff_over_lr": diff / lrs[algo]})
            worst = {k: max(r[k] for r in rows)
                     for k in ("stats_max_rel_diff", "params_max_abs_diff_over_lr")}
            emit({"phase": "d_learners", "algo": algo, "gang": "built by this script",
                  "updates": rows, "global_batch": len(next(iter(bs[0].values()))), **worst,
                  "tol": {"stats_rtol": RL_STATS_RTOL, "params_lr_fraction": RL_PARAMS_LR_FRACTION},
                  "gang_update_s": update_s, "nvidia_smi": run.smi})
            if worst["stats_max_rel_diff"] > RL_STATS_RTOL or \
                    worst["params_max_abs_diff_over_lr"] > RL_PARAMS_LR_FRACTION:
                failed.append((algo, worst))
        learners = group.learner_info
        emit({"phase": "d_learners", "part": "gang", "built_by": "this script",
              "learners": learners, "start_s": start_s, "one_learner": str(dev),
              "nvidia_smi": run.smi})
    finally:
        teardown_s = _teardown("dqn-ppo", group.shutdown, run)
    if teardown_s > TEARDOWN_BOUND_S:
        failed.append(("dqn-ppo teardown_s", teardown_s))
    return learners, failed


#: part (d)'s gangs: IMPALA's own, and the DQN/PPO one this script builds
LEARNER_RUNS = {"impala": impala_gang, "dqn-ppo": built_gang}


def part_d(run: Run, cluster, names) -> None:
    """Four learners against one learner on the concatenated batch, update
    by update: before each, the one learner takes the gang's state (Adam
    turns rounding-level differences of a near-zero gradient into steps of
    up to lr apart, which compound over updates, so each update is held on
    its own, as ``chip_smoke.py`` ``rl`` (b) holds the card against the
    CPU). The gangs of ``LEARNER_RUNS`` named in ``names``; each learner
    leases a card of its own."""
    failed = []
    for name, gang in LEARNER_RUNS.items():
        if name not in names:
            continue
        learners, bad = gang(run)
        failed += bad
        if run.on_card:
            leased = [i["cuda_visible_devices"] for i in learners]
            check(len(set(leased)) == WORLD and "" not in leased,
                  f"{name}: each learner leased its own card: {leased}")
    check(not failed, f"4 learners against one: {failed}")


# ---------------------------------------------------------------------------
# (e) serving across cards


F32_ENGINE = dict(block_size=16, num_blocks=288, prefill_buckets=(64, 256),
                  decode_buckets=(1, 2, 4, 8), max_decode_batch=8, warmup=False)
TINY_ENGINE = dict(block_size=16, num_blocks=256, prefill_buckets=(64,),
                   decode_buckets=(1, 2, 4, 8), max_decode_batch=8, warmup=False)
F32_STREAMS, F32_NEW_TOKENS = 8, 48
DISAGG_HANDOFFS = 16


def _replicas(rt, name, n: int = 1):
    """The deployment's replica actors, once ``n`` of them are running."""
    ctrl = rt.get_actor("__serve_controller__")
    rt.get(ctrl.wait_status.remote(name, min_replicas=n, timeout_s=600), timeout=630)
    return rt.get(ctrl.get_replicas.remote(name), timeout=60)


def _call(rt, replica, method, *args):
    return rt.get(replica.handle_request.remote(method, list(args), {}, ""), timeout=120)


def _scrape(rt, replica, name: str) -> float:
    import urllib.request

    addr = _call(rt, replica, "metrics_address")
    body = urllib.request.urlopen(f"http://{addr}/metrics", timeout=30).read().decode()
    return sum(float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
               if line.startswith(name) and " " in line)


def _wait_gpus_free(rt, n: int, timeout_s: float = 120.0) -> None:
    """Waits until ``n`` GPUs are free again (a deleted deployment's
    replicas give their leases back as their processes exit)."""
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + timeout_s
    while rt.available_resources().get("GPU", 0) < n:
        if time.monotonic() > deadline:
            alive = [(a["class_name"], a["pid"]) for a in state.list_actors()
                     if a["state"] == "ALIVE"]
            check(False, f"the GPUs come back: {rt.available_resources()}, alive {alive}")
        time.sleep(0.2)


def f32_requests(vocab: int, tiny: bool):
    """``F32_STREAMS`` requests of 40-190 prompt tokens (20-60 tiny), half
    greedy, half seeded at temperature 0.8."""
    import numpy as np

    rs = np.random.RandomState(31)
    lo, hi = (20, 61) if tiny else (40, 191)
    return [dict(prompt=[int(x) for x in rs.randint(1, vocab, size=rs.randint(lo, hi))],
                 max_new_tokens=F32_NEW_TOKENS, request_id=f"w{i}",
                 **({} if i % 2 == 0 else dict(temperature=0.8, seed=3000 + i)))
            for i in range(F32_STREAMS)]


def serve_two_replicas_f32(run: Run, rt, serve, cfg32, engine) -> None:
    """Two replicas in f32: streams equal an in-process server's, one
    replica SIGKILLed mid-stream and its streams resumed on the other."""
    import signal
    import threading

    import torch

    from ray_tpu_torch.inference import LLMServer
    from ray_tpu_torch.observability.rpc_metrics import STREAM_RESUMES

    t0 = time.perf_counter()
    device = {} if run.on_card else {"device": "cpu"}
    opts = {"num_gpus": 1} if run.on_card else {"num_cpus": 0.5}
    reqs = f32_requests(cfg32.vocab_size, run.tiny)
    local = LLMServer(cfg32, engine, seed=1, **device)
    try:
        expected = [[t for chunk in local.generate(dict(r)) for t in chunk] for r in reqs]
    finally:
        local.engine.stop()
    del local
    _free(torch)
    dep = serve.llm_deployment(cfg32, engine=engine, name="mc32", route_prefix="/mc32", seed=1,
                               num_replicas=2, max_concurrent_queries=8, ray_actor_options=opts)
    handle = serve.run(dep.bind(**device))
    reps = _replicas(rt, "mc32", 2)
    infos = [_call(rt, r, "testing_device_info") for r in reps]
    served = [stream_request(handle, dict(r))[0] for r in reqs]
    resumes0 = STREAM_RESUMES._values.get(("mc32",), 0.0)
    got = [None] * len(reqs)
    started = threading.Barrier(len(reqs) + 1, timeout=300)
    errors = []

    def consume(i):
        try:
            it = iter(handle.stream(dict(reqs[i], request_id=f"k{i}"), _method="generate",
                                    _timeout=600))
            toks = [next(it) for _ in range(3)]
            started.wait()
            got[i] = toks + list(it)
        except Exception as e:  # noqa: BLE001 — checked below
            errors.append(repr(e))
            started.abort()

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    started.wait()
    victim = infos[0]["pid"]
    os.kill(victim, signal.SIGKILL)
    for t in threads:
        t.join(timeout=600)
    resumes = STREAM_RESUMES._values.get(("mc32",), 0.0) - resumes0
    # the controller replaces the killed replica before the deployment goes
    ctrl = rt.get_actor("__serve_controller__")
    status = rt.get(ctrl.wait_status.remote("mc32", min_replicas=2, timeout_s=300), timeout=330)
    emit({"phase": "e_serve", "part": "two_replicas_f32",
          "config": "llama2_7b(n_layers=2) float32" if not run.tiny else "tiny float32",
          "replicas": [{k: i[k] for k in ("pid", "cuda_visible_devices", "device", "init_s")}
                       for i in infos],
          "streams_equal": [a == b for a, b in zip(served, expected)],
          "killed_pid": victim, "resumed_streams_equal": [a == b for a, b in zip(got, expected)],
          "resumes": resumes, "errors": errors, "restarts": status["restarts"],
          "replicas_after": status["replicas"], "seconds": time.perf_counter() - t0,
          "nvidia_smi": run.smi})
    if run.on_card:
        cards = [i["cuda_visible_devices"] for i in infos]
        check(len(set(cards)) == 2 and "" not in cards, f"a card a replica: {cards}")
    check(all(a == b for a, b in zip(served, expected)),
          "f32 streams through two replicas equal the in-process server's")
    check(not errors and all(a == b for a, b in zip(got, expected)),
          f"streams cut by the SIGKILL resume equal on the survivor: {errors}")
    check(resumes >= 1, f"the router resumed streams of the killed replica: {resumes}")
    serve.delete("mc32")


def serve_two_replicas_7b(run: Run, rt, serve, cfg, engine) -> None:
    from ray_tpu_torch.observability.rpc_metrics import STREAM_RESUMES

    opts = {"num_gpus": 1} if run.on_card else {"num_cpus": 0.5}
    device = {} if run.on_card else {"device": "cpu"}
    t0 = time.perf_counter()
    dep = serve.llm_deployment(cfg, engine=engine, name="mc7b", route_prefix="/mc7b", seed=0,
                               num_replicas=2, max_concurrent_queries=16, ray_actor_options=opts)
    handle = serve.run(dep.bind(**device))
    reps = _replicas(rt, "mc7b", 2)
    ready_s = time.perf_counter() - t0
    resumes0 = STREAM_RESUMES._values.get(("mc7b",), 0.0)
    t0 = time.perf_counter()
    # tiny: prompts of 16-128 tokens, request 1 request 0's first 32
    traffic = dict(lens=(16, 128), prefix=32) if run.tiny else {}
    results = serve_traffic(HandleClient(handle), cfg.vocab_size, seed=13, **traffic)
    wall_s = time.perf_counter() - t0
    stats = [_call(rt, r, "engine_stats") for r in reps]
    infos = [_call(rt, r, "testing_device_info") for r in reps]
    n_tokens = sum(len(r[2]) for r in results)
    gaps = [b - a for r in results for a, b in zip(r[4], r[4][1:])]
    emit({"phase": "e_serve", "part": "two_replicas_7b", "config": "llama2_7b() bf16"
          if not run.tiny else "tiny", "engine": engine.__dict__ if hasattr(engine, "__dict__")
          else str(engine), "deploy_to_ready_s": ready_s,
          "replicas": [{"pid": i["pid"], "cuda_visible_devices": i["cuda_visible_devices"],
                        "init_s": i["init_s"],
                        "max_memory_allocated_bytes": i["max_memory_allocated_bytes"],
                        "requests": s["scheduler"].get("total_admitted"),
                        "prefix_hits": s["prefix_cache"]["hits_total"],
                        "used_blocks": s["blocks"]["used_blocks"]}
                       for i, s in zip(infos, stats)],
          "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
          "answered": sum(len(r[2]) == SERVE_NEW_TOKENS for r in results),
          "resumes": STREAM_RESUMES._values.get(("mc7b",), 0.0) - resumes0,
          "ttft_s": quantiles([r[4][0] - r[3] for r in results]), "itl_s": quantiles(gaps),
          "wall_s": wall_s, "generated_tokens": n_tokens,
          "generated_tokens_per_s": n_tokens / wall_s,
          "one_replica": "chip_smoke.py serve_deployment c_serve_7b: 69.6 tokens/s",
          "nvidia_smi": run.smi})
    check(all(len(r[2]) == SERVE_NEW_TOKENS for r in results),
          f"two replicas answer {SERVE_REQUESTS} of {SERVE_REQUESTS}")
    check(all(s["blocks"]["used_blocks"] == 0 for s in stats), "every block came back")
    check(all((s["scheduler"].get("total_admitted") or 0) > 0 for s in stats),
          "both replicas served requests")
    if run.on_card:
        cards = [i["cuda_visible_devices"] for i in infos]
        check(len(set(cards)) == 2, f"a card a replica: {cards}")
    serve.delete("mc7b")


def serve_disaggregated(run: Run, rt, serve, cfg, engine, reqs, expected, what: str):
    """Prefill and decode pools, each a replica on its own card: the streams
    (equal ``expected`` where given), the migration counters, and each
    handoff's stages from the replicas' request ledgers."""
    from ray_tpu_torch.inference import kv_transfer

    opts = {"num_gpus": 1} if run.on_card else {"num_cpus": 0.5}
    device = {} if run.on_card else {"device": "cpu"}
    name = f"mcd{what}"
    t0 = time.perf_counter()
    dep = serve.llm_deployment(cfg, engine=engine, name=name, route_prefix=f"/{name}", seed=1,
                               disaggregated=True, ray_actor_options=opts)
    handle = serve.run(dep.bind(**device))
    ready_s = time.perf_counter() - t0
    decode, prefill = _replicas(rt, name)[0], _replicas(rt, f"{name}-prefill")[0]
    infos = [_call(rt, r, "testing_device_info") for r in (prefill, decode)]
    fb = kv_transfer.migration_metrics()["fallbacks"]
    fb0 = sum(fb._values.values())
    saved0 = _call(rt, decode, "engine_stats")["prefix_cache"]["tokens_saved_total"]
    tr0 = _scrape(rt, decode, "raytpu_kv_migration_transfers_total ")
    by0 = _scrape(rt, decode, "raytpu_kv_migration_bytes_total ")
    rfb0 = _scrape(rt, decode, "raytpu_kv_migration_fallbacks_total")
    t0 = time.perf_counter()
    streams, ttft = [], []
    for i, r in enumerate(reqs):
        t1 = time.perf_counter()
        streams.append(stream_request(handle, dict(r, request_id=f"{what}{i}")))
        ttft.append(streams[-1][1][0] - t1)
    wall_s = time.perf_counter() - t0
    saved = _call(rt, decode, "engine_stats")["prefix_cache"]["tokens_saved_total"] - saved0
    transfers = _scrape(rt, decode, "raytpu_kv_migration_transfers_total ") - tr0
    nbytes = _scrape(rt, decode, "raytpu_kv_migration_bytes_total ") - by0
    fallbacks = _scrape(rt, decode, "raytpu_kv_migration_fallbacks_total") - rfb0 \
        + sum(fb._values.values()) - fb0
    stages = {}
    for role, rep in (("prefill", prefill), ("decode", decode)):
        for e in _call(rt, rep, "slo_snapshot").get("flight", []):
            rid = str(e.get("request_id") or "")
            if rid.startswith(what):
                for k, v in (e.get("stages") or {}).items():
                    stages.setdefault(f"{role}.{k}", []).append(1e3 * v)
    reading = {"phase": "e_serve", "part": f"disaggregated_{what}", "deploy_to_ready_s": ready_s,
               "pools": {"prefill": {k: infos[0][k] for k in ("pid", "cuda_visible_devices")},
                         "decode": {k: infos[1][k] for k in ("pid", "cuda_visible_devices")}},
               "handoffs": len(reqs), "prompt_lens": [len(r["prompt"]) for r in reqs],
               "transfers": transfers, "bytes": nbytes,
               "bytes_per_handoff": nbytes / transfers if transfers else None,
               "prefix_tokens_saved": saved, "fallbacks": fallbacks,
               "stage_ms": {k: quantiles(v) for k, v in sorted(stages.items())},
               "ttft_s": quantiles(ttft),
               "wall_s": wall_s, "nvidia_smi": run.smi}
    if expected is not None:
        reading["streams_equal"] = [s[0] == e for s, e in zip(streams, expected)]
    emit(reading)
    if run.on_card:
        cards = [i["cuda_visible_devices"] for i in infos]
        check(len(set(cards)) == 2 and "" not in cards, f"a card a pool: {cards}")
    check(transfers >= len(reqs) and fallbacks == 0 and saved > 0,
          f"{what}: every handoff migrated ({transfers}), none fell back ({fallbacks}), "
          f"the importer saved {saved} prefix tokens")
    if expected is not None:
        check(all(reading["streams_equal"]), f"{what}: disaggregated streams equal the plain ones")
    else:
        check(all(len(s[0]) == r["max_new_tokens"] for s, r in zip(streams, reqs)),
              f"{what}: every stream finished")
    serve.delete(name)
    serve.delete(f"{name}-prefill")


def part_e(run: Run, cluster) -> None:
    import numpy as np
    import torch

    from ray_tpu_torch import serve
    from ray_tpu_torch.inference import EngineConfig, LLMServer
    from ray_tpu_torch.models import llama as L
    import ray_tpu_torch as rt

    try:
        if run.tiny:
            cfg32 = L.LlamaConfig.tiny(dtype=torch.float32, max_seq_len=256)
            f32_engine = EngineConfig(**TINY_ENGINE)
        else:
            cfg32 = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
            f32_engine = EngineConfig(**F32_ENGINE)
        serve_two_replicas_f32(run, rt, serve, cfg32, f32_engine)
        _wait_gpus_free(rt, 4 if run.on_card else 0)
        if run.on_card:
            cfg7b, engine7b = L.LlamaConfig.llama2_7b(), EngineConfig(**SERVE_ENGINE)
        else:
            cfg7b = L.LlamaConfig.tiny(dtype=torch.bfloat16, max_seq_len=256)
            engine7b = EngineConfig(**TINY_ENGINE)
        serve_two_replicas_7b(run, rt, serve, cfg7b, engine7b)
        _wait_gpus_free(rt, 4 if run.on_card else 0)
        # disaggregated pools in f32, streams against the plain server's
        reqs = f32_requests(cfg32.vocab_size, run.tiny)
        device = {} if run.on_card else {"device": "cpu"}
        local = LLMServer(cfg32, f32_engine, seed=1, **device)
        try:
            expected = [[t for chunk in local.generate(dict(r)) for t in chunk] for r in reqs]
        finally:
            local.engine.stop()
        del local
        _free(torch)
        serve_disaggregated(run, rt, serve, cfg32, f32_engine, reqs, expected, "f32")
        _wait_gpus_free(rt, 4 if run.on_card else 0)
        rs = np.random.RandomState(41)
        lo, hi = (20, 61) if run.tiny else (256, 1025)
        reqs7 = [dict(prompt=[int(x) for x in rs.randint(1, cfg7b.vocab_size, size=n)],
                      max_new_tokens=16) for n in rs.randint(lo, hi, size=DISAGG_HANDOFFS)]
        serve_disaggregated(run, rt, serve, cfg7b, engine7b, reqs7, None, "bf16")
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------------
# driver


def cluster_start(run: Run) -> dict:
    import ray_tpu_torch as rt

    if run.on_card:
        rt.init(num_cpus=12)
    else:
        rt.init(num_cpus=12, resources={"GPU": 0})
    total = rt.cluster_resources()
    return {"gpus": total.get("GPU", 0), "cpus": total.get("CPU", 0)}


def devices_line(run: Run) -> dict:
    import torch

    if not run.on_card:
        return {"phase": "devices", "platform": "cpu", "world": WORLD, "torch": torch.__version__}
    cards = nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()
    run.smi = cards[0]
    links = {}
    for args in (("topo", "-m"), ("nvlink", "--status")):
        try:
            links[" ".join(args)] = nvidia_smi(*args)
        except (OSError, subprocess.SubprocessError) as e:
            links[" ".join(args)] = f"not read: {e!r}"
    n = torch.cuda.device_count()
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n)]
             for i in range(n)]
    nccl = torch.cuda.nccl.version()
    return {"phase": "devices", "nvidia_smi": cards, "links": links, "peer_access": peers,
            "nccl": nccl if isinstance(nccl, int) else ".".join(map(str, nccl)),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "count": torch.cuda.device_count(),
            "names": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}


def watchdog(deadline_s: float) -> None:
    """Past ``deadline_s`` from the start: kill every process this one
    started (the spawned ranks, the cluster's) and exit with 3."""
    import signal
    import threading

    def fire():
        from ray_tpu_torch.util.reaper import find_runtime_pids

        emit({"phase": "deadline", "seconds": time.perf_counter() - T_START})
        for pid in set(find_runtime_pids(spawner_pid=os.getpid())) | _children():
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        os._exit(3)

    timer = threading.Timer(max(0.0, deadline_s - (time.perf_counter() - T_START)), fire)
    timer.daemon = True
    timer.start()


def _children() -> set:
    """Pids of this process's direct children (``/proc``)."""
    me, out = str(os.getpid()), set()
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if (d / "stat").read_text().rsplit(")", 1)[1].split()[1] == me:
                    out.add(int(d.name))
            except (OSError, IndexError):
                pass
    return out


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m ray_tpu_torch.tools.multi_card_smoke")
    p.add_argument("--part", action="append", choices=("a", "b", "c", "d", "e"),
                   help="run only this part (repeatable); every part by default")
    p.add_argument("--case", action="append",
                   choices=[c[0] for c in CASES] + list(TRAINER_NAMES) + list(LEARNER_RUNS),
                   help="only this case of part (b), (c) or (d) (repeatable); a part none of "
                        "whose cases is named runs every one")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true", help="LlamaConfig.tiny sizes")
    p.add_argument("--out", default=str(ROOT / "ray_tpu_torch" / "_build" / "multi_card"),
                   help="readings and each rank's log (default under the ignored _build/)")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--job", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker_main(args.worker, args.rank, args.port, args.job)
    bytecode_cache()
    import torch

    if args.platform == "cuda":
        if not torch.cuda.is_available():
            print("multi_card_smoke: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < WORLD:
            print(f"multi_card_smoke: {torch.cuda.device_count()} cards, {WORLD} needed",
                  file=sys.stderr)
            return 2
    run = Run(args.platform, args.tiny, Path(args.out))
    run.out.mkdir(parents=True, exist_ok=True)
    watchdog(RUN_DEADLINE_S)
    emit(devices_line(run))
    if run.on_card:
        from ray_tpu_torch.ops import _build

        _, report = _build.build()  # once, before any rank starts
        emit({"phase": "build", "seconds": report["seconds"], "cached": report["cached"]})
    parts = args.part or ["a", "b", "c", "d", "e"]
    asked = set(args.case or ())
    cases = [c[0] for c in CASES if c[0] in asked] or [c[0] for c in CASES]
    trainer_runs = [n for n in TRAINER_NAMES if n in asked] or list(TRAINER_NAMES)
    learner_runs = [n for n in LEARNER_RUNS if n in asked] or list(LEARNER_RUNS)
    failed, cluster = {}, None
    import ray_tpu_torch as rt

    try:
        for part in parts:
            t0 = time.perf_counter()
            try:
                if part == "b":
                    part_b(run, cases)
                else:
                    if cluster is None:
                        cluster = cluster_start(run)
                        if run.on_card:
                            check(cluster["gpus"] == WORLD,
                                  f"the node daemon detected {WORLD} GPUs: {cluster}")
                    if part == "c":
                        part_c(run, cluster, trainer_runs)
                    elif part == "d":
                        part_d(run, cluster, learner_runs)
                    else:
                        {"a": part_a, "e": part_e}[part](run, cluster)
            except Exception as e:  # noqa: BLE001 — every part runs; the exit code says
                import traceback

                failed[part] = repr(e)[-2000:]
                traceback.print_exc()
            emit({"phase": "part", "part": part, "ok": part not in failed,
                  "seconds": time.perf_counter() - t0})
    finally:
        if cluster is not None:
            rt.shutdown()
    from ray_tpu_torch.util.reaper import find_runtime_pids

    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "total", "parts": parts, "failed": failed, "left": left,
          "seconds": time.perf_counter() - T_START})
    if failed or left:
        return 1
    if run.on_card:
        print(run.smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    else:
        emit({"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": WORLD}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
