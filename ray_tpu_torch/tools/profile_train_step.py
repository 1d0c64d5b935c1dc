"""Where the time of one Llama training step goes, on the card.

``python -m ray_tpu_torch.tools.profile_train_step [--seed N]`` builds the
training slice with ``train_slice`` (7B width, 4 layers, batch 2 x 2048,
bf16, AdamW) -- the same function ``chip_smoke.py`` builds the slice it
times with -- warms it up for one step, then records 2 steps under
``torch.profiler`` (CPU + CUDA activities). It prints one JSON line:

* ``step_ms``: host wall time per profiled step (the profiler's own cost
  included; ``chip_smoke.py`` gives the step time with profiling off);
* ``device_busy_ms`` and ``idle_share``: the summed self device time of
  every kernel in the window against its wall time;
* ``groups``: device time by group (the port's flash kernels, GEMMs, the
  rest), and ``top``: the kernels with the most device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ray_tpu_torch.models import llama as L


#: the training slice: depth cut from 32 to 4 layers, one fixed batch
SLICE = dict(n_layers=4, batch=2, seq=2048, lr=1e-4)


def train_slice(seed: int = 0):
    """The slice's ``(cfg, state, step, batch)`` on the card: random weights
    from ``seed``, AdamW at ``SLICE["lr"]``, a random token batch from
    ``seed + 3``."""
    cfg = L.LlamaConfig.llama2_7b(n_layers=SLICE["n_layers"])
    model = L.init_params(cfg, seed)
    opt = L.adamw(SLICE["lr"])(model.parameters())
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    seqs = torch.randint(0, cfg.vocab_size, (SLICE["batch"], SLICE["seq"] + 1), generator=g,
                         device="cuda")
    batch = {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}
    return cfg, (model, opt), L.make_train_step(cfg), batch


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _group(name: str) -> str:
    low = name.lower()
    if "flash_" in low and "rtt" in low:
        return "port flash kernels"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "gemm"
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    n_steps = 2

    _, state, step, batch = train_slice(args.seed)
    state, _ = step(state, batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, loss = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    # device events that are kernels, not user-annotation ranges such as
    # "Optimizer.step#AdamW.step" (those span kernels already counted)
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    groups: dict = {}
    for e in kernels:
        groups[_group(e.key)] = groups.get(_group(e.key), 0.0) + _device_us(e) / 1e3 / n_steps
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "config": "LlamaConfig.llama2_7b(n_layers={n_layers}) b={batch} S={seq} bf16".format(
            **SLICE),
        "steps": n_steps, "step_ms": wall_ms / n_steps,
        "device_busy_ms": busy_ms / n_steps, "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms_per_step": groups,
        "top": [{"kernel": e.key[:90], "ms_per_step": _device_us(e) / 1e3 / n_steps,
                 "calls_per_step": e.count / n_steps} for e in top],
        "loss": float(loss), "nvidia_smi": smi,
    }))


if __name__ == "__main__":
    main()
