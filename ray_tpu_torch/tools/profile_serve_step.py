"""Where the time of the serving steps goes, on the card.

``python -m ray_tpu_torch.tools.profile_serve_step`` builds Llama-2-7B at
full width and depth (bf16, random weights from seed 0) behind a
``PagedModelRunner`` with the serving configuration of ``chip_smoke.py``
(block size 16, 640 blocks), prefills 8 prompts of 512 tokens, and records
under ``torch.profiler`` (CPU + CUDA activities):

* ``decode``: 4 decode steps of the 8 slots;
* ``prefill``: one 512-token prefill chunk.

One JSON line each: host wall time per step, the summed device time of
every kernel against it (``idle_share``), device time by group (GEMMs, the
K/V gathers and scatters, copies, softmax, the rest), the kernels with the
most time, and ``bound_ms``: the least time for the step's work on this
card, the larger of its bytes (weights, the embedding rows looked up and
the live K/V each read once, logits written once) over 3.35 TB/s and its
matmul FLOPs over 989 TFLOP/s.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from ray_tpu_torch.inference import PagedBlockManager, PagedModelRunner
from ray_tpu_torch.models import llama as L
from ray_tpu_torch.tools.profile_train_step import _device_us

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
SLOTS, PROMPT, BLOCK, NUM_BLOCKS, DECODE_STEPS = 8, 512, 16, 640, 4


def _group(name: str) -> str:
    low = name.lower()
    if any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "gemm"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gather/scatter"
    if "softmax" in low:
        return "softmax"
    if "copy" in low or "cat" in low:
        return "copy"
    return "other"


def _profile(fn, n: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    groups: dict = {}
    for e in kernels:
        groups[_group(e.key)] = groups.get(_group(e.key), 0.0) + _device_us(e) / 1e3 / n
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    return {"steps": n, "step_ms": wall_ms / n, "device_busy_ms": busy_ms / n,
            "idle_share": 1 - busy_ms / wall_ms, "groups_ms_per_step": groups,
            "top": [{"kernel": e.key[:90], "ms_per_step": _device_us(e) / 1e3 / n,
                     "calls_per_step": e.count / n} for e in top]}


def _bound_ms(cfg, tokens: int, kv_tokens: int, pairs: int) -> tuple:
    """(ms, "bytes" | "operations") for ``tokens`` new positions: the
    weights (of the embedding table only the ``tokens`` rows looked up)
    and ``kv_tokens`` positions of K/V moved once, f32 logits written,
    and ``pairs`` (query, key) score pairs over all heads."""
    esz = 2
    dense = L.param_count(cfg) - cfg.vocab_size * cfg.dim  # all but the embedding table
    kv = kv_tokens * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * esz
    rows = min(tokens, cfg.vocab_size) * cfg.dim
    nbytes = (dense + rows) * esz + kv + tokens * cfg.vocab_size * 4
    flops = 2 * dense * tokens + 4 * cfg.n_layers * cfg.dim * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> None:
    cfg = L.LlamaConfig.llama2_7b()
    params = L.init_params(cfg, 0)
    runner = PagedModelRunner(cfg, params, num_blocks=NUM_BLOCKS, block_size=BLOCK,
                              prefill_buckets=(PROMPT,), decode_buckets=(SLOTS,))
    mgr = PagedBlockManager(NUM_BLOCKS, BLOCK)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size, (SLOTS + 1, PROMPT), generator=gen).tolist()
    rows = []
    for i in range(SLOTS):
        mgr.grow_to(f"r{i}", PROMPT + 2 * DECODE_STEPS + 1)
        rows.append(mgr.table_row(f"r{i}", runner.max_blocks_per_seq))
        runner.prefill_chunk(prompts[i], rows[i], 0)
    pos = [PROMPT]

    def decode():
        p = pos[0]
        runner.decode([1] * SLOTS, [p] * SLOTS, rows, [p + 1] * SLOTS)
        pos[0] += 1

    decode()  # warm
    mgr.grow_to("extra", PROMPT)
    extra = mgr.table_row("extra", runner.max_blocks_per_seq)
    runner.prefill_chunk(prompts[SLOTS], extra, 0)  # warm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    ctx = pos[0]
    kv_live = SLOTS * (ctx + DECODE_STEPS // 2)
    out = _profile(decode, DECODE_STEPS)
    bms, by = _bound_ms(cfg, SLOTS, kv_live, kv_live)
    print(json.dumps({"window": "decode", "config": "LlamaConfig.llama2_7b() bf16",
                      "slots": SLOTS, "context": ctx, **out, "bound_ms": bms,
                      "bound_by": by, "nvidia_smi": smi}), flush=True)
    out = _profile(lambda: runner.prefill_chunk(prompts[SLOTS], extra, 0), 1)
    bms, by = _bound_ms(cfg, PROMPT, PROMPT, PROMPT * (PROMPT + 1) // 2)
    print(json.dumps({"window": "prefill", "config": "LlamaConfig.llama2_7b() bf16",
                      "chunk": PROMPT, **out, "bound_ms": bms, "bound_by": by,
                      "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
