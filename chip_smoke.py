#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
one card). It imports nothing of JAX or of ``ray_tpu``. Phases, each one
JSON line on stdout:

1. device + build: the card (``nvidia-smi`` name and power limit), then the
   flash-attention kernels built from ``ray_tpu_torch/ops/csrc`` for
   ``sm_90a`` (build seconds, registers/spills from ``-Xptxas -v``, dynamic
   shared memory per block); each of the three has two kernels, bf16 on the
   tensor cores (``flash_fwd_tc.cu``, ``flash_bwd_dq_tc.cu``,
   ``flash_bwd_dkv_tc.cu``, none of which may spill at d=128) and f32 on the
   CUDA cores (``flash_fwd.cu``, ``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``);
2. parity: each kernel against its plain PyTorch version on the same
   inputs, at the training slice's shapes (b=2, h=32, S=2048, d=128, bf16,
   causal) and at GQA, non-causal, f32 and S=1000 variants, every element
   held to its own size and its row's (``tools/kernel_check.py``);
3. reference: the tiny Llama (f32) through the kernels against the same
   model through the plain attention reference (logits, loss, and every
   gradient leaf by relative norm);
4. times: each kernel, its plain version and the PyTorch library call for
   the same function (``scaled_dot_product_attention`` forward/backward,
   timed only as a yardstick) with CUDA events, beside the card's bound,
   and the dq and dk/dv kernels together against SDPA's one backward call
   and against the bound of the function that call computes;
5. slice: the Llama training step at 7B width (depth cut to 4 layers),
   one warm step and 3 timed steps on a fixed batch; the loss must be
   finite and fall, each kernel's launch count must equal
   ``n_layers x steps``, and every launch of every kernel must take the
   tensor-core route;
6. serve (the training state freed first): (a) the paged-KV steps through
   ``PagedModelRunner`` (a prompt prefilled in 2 chunks, then 8 decode
   steps, at each decode bucket 1-8, and beside 7 live requests) against
   the dense ``forward`` on the same token prefix, in f32 at 2 layers
   with TF32 off (relative RMS bound ``F32_REL_RMS``) and in bf16 at
   Llama-2-7B's full width and depth (``BF16_REL_RMS`` and a least count
   of top-1 agreements); at 2
   layers in f32, 8 requests decoding together must each equal the same
   request sent alone, and the greedy ones the dense greedy loop;
   (b) ``InferenceEngine`` at that size (``SERVE_ENGINE``) answering 64
   requests from 8 client threads (8 in flight), prompts of 64-1024
   tokens, two sharing a 512-token prefix, 32 new tokens each, half greedy
   and half sampled: every request must finish, no new shape may appear
   after warmup, every block must come back, the prefix cache must hit and
   copy, a seeded request sent again on the same path (a full-prompt
   prefix hit both times) must repeat its tokens, and the
   serve path must launch none of the three flash kernels (it has none:
   the paged steps are plain torch ops, as the JAX steps are XLA ops); it
   prints init and warmup seconds, TTFT and ITL quantiles over every
   request, generated tokens/s, step times and peak memory;
   (c) the engine's byte-exact contracts on the tiny config in f32 on the
   card, each run's requests decoding together: greedy streams equal a
   dense greedy loop, seeded sampled streams equal the same requests sent
   alone, speculative decoding equals plain decode, a shared-prefix run
   equals a prefix-cache-off run;
7. serve_llm (the serve phase's engines freed first; the flash kernels'
   counts set to 0 before it and read after, all 0): ``LLMServer``, the
   in-process serving surface. (a) f32, TF32 off, at 7B width with depth
   cut to 2 layers: 4 requests (2 greedy, 2 seeded at temperature 0.8)
   streamed undisturbed on one server, then resumed at k = 1, 5, 11 with
   ``prompt + delivered[:k]`` and ``resume_from=k`` on a plain and on a
   speculative survivor built from the same seed: every tail must equal
   the undisturbed stream byte for byte from seq k, and the delivered-EOS
   and room-clamped resumes must yield nothing; (b) the same server in a
   child process (``tools/chaos_stream.py``) armed with
   ``kill_mid_decode:1.0:6`` through ``RAY_TPU_testing_replica_chaos``:
   it must die by SIGKILL mid-stream, and the stream, resumed here behind
   a ``SeqGate``, must have no gap and no repeat and equal the undisturbed
   one; (c) full Llama-2-7B in bf16 on two servers sharing one params
   object (``SERVE_ENGINE`` with ``step_stall_unhealthy_s=1.0``):
   ``stall:1.0:3.0:1`` armed on one, whose ``check_health()`` must read
   False during the stall and True after, its tokens equal to the unarmed
   server's; (d) 8 requests from 8 client threads (prompts of 64-1024
   tokens, 32 new tokens, half greedy, half seeded at 0.8) streamed
   undisturbed on one server, then each cut after k = 1, 5, 11 or 20
   tokens on the other by closing its stream and resumed on the first:
   every stream must end with 32 tokens and contiguous seq numbers, every
   block of both servers must come back and no shape may appear after
   warmup. It reports, not gates, how many resumed tails equal the
   undisturbed streams in bf16 and the resume TTFT against the cold one.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last the
``{"ok": true, "device": ...}`` line. Any failed check raises: the script
then exits non-zero without the last line. Without a CUDA device it exits
non-zero before printing anything.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

#: peak rates of one H100 SXM (NVIDIA data sheet; dense tensor-core bf16,
#: CUDA-core f32, HBM3)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TPU_KERNELS = {  # wrapper → (TPU kernel it replaces, file:line of its body)
    "flash_fwd": ("_fwd_kernel", "ray_tpu/ops/attention.py:149"),
    "flash_bwd_dq": ("_bwd_dq_kernel", "ray_tpu/ops/attention.py:269"),
    "flash_bwd_dkv": ("_bwd_dkv_kernel", "ray_tpu/ops/attention.py:311"),
}
SOURCES = {  # the kernel each wrapper launches on the bf16 main path
    "flash_fwd": "ray_tpu_torch/ops/csrc/flash_fwd_tc.cu",
    "flash_bwd_dq": "ray_tpu_torch/ops/csrc/flash_bwd_dq_tc.cu",
    "flash_bwd_dkv": "ray_tpu_torch/ops/csrc/flash_bwd_dkv_tc.cu",
}
#: (kernel, dtype) pairs the library instantiates, each at every head dim
INSTANTIATED = (("flash_fwd_kernel", "f32"), ("flash_fwd_tc_kernel", "bf16"),
                ("flash_bwd_dq_kernel", "f32"), ("flash_bwd_dq_tc_kernel", "bf16"),
                ("flash_bwd_dkv_kernel", "f32"), ("flash_bwd_dkv_tc_kernel", "bf16"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. build


def phase_build(torch):
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.attention import KERNEL_HEAD_DIMS

    path, report = _build.build()
    lib = _build.library()
    smem = {k + tc: {d: getattr(lib, f"rtt_{k}{tc}_smem_bytes")(d) for d in KERNEL_HEAD_DIMS}
            for k in SOURCES for tc in ("", "_tc")}
    regs = _build.ptxas_summary(report["ptxas"])
    got = sorted((r["kernel"], r["dtype"], r["d"]) for r in regs)
    want = sorted((k, dt, d) for k, dt in INSTANTIATED for d in KERNEL_HEAD_DIMS)
    check(got == want, f"ptxas reported {got}, expected {want}")
    tc128 = {r["kernel"]: r for r in regs if r["kernel"].endswith("_tc_kernel") and r["d"] == 128}
    emit({"phase": "build", "arch": "sm_90a", "library": path.name,
          "seconds": report["seconds"], "cached": report["cached"],
          "dynamic_smem_bytes": smem, "tc_d128": tc128, "ptxas": regs})
    for r in tc128.values():
        check(r["spill_bytes"] == 0, f"tensor-core kernel spills at d=128: {r}")


# ---------------------------------------------------------------------------
# 2. kernel parity


def phase_parity(K, A):
    """Each kernel against its plain version in every case of
    ``kernel_check.CASES``, by the rule of ``kernel_check.compare``."""
    main_err = {}
    for name, c in K.CASES.items():
        readings = K.parity_case(A, c)
        emit({"phase": "parity", "case": name, **c, "tol": K.TOL[c["dtype"]],
              "floor": K.FLOOR, "readings": readings})
        for what, r in readings.items():
            check(r["ok"], f"{name}/{what}: {r}")
        if name == "main":
            main_err = {"flash_fwd": readings["o"]["max_abs_err"],
                        "flash_bwd_dq": readings["dq"]["max_abs_err"],
                        "flash_bwd_dkv": max(readings["dk"]["max_abs_err"],
                                             readings["dv"]["max_abs_err"])}
    return main_err


# ---------------------------------------------------------------------------
# 3. small end-to-end reference


def phase_reference(K, L):
    """Tiny Llama in f32: kernels ("pallas") against the plain attention
    reference ("xla") with the same weights. Logits, loss and each gradient
    leaf by relative norm, bound ``kernel_check.TINY_REL_TOL``."""
    ref = K.tiny_reference(L)
    emit({"phase": "reference", "config": "LlamaConfig.tiny(max_seq_len=128) f32", **ref})
    check(ref["shape_ok"], "tiny logits finite with the expected shape")
    check(ref["ok"], f"tiny reference: max relative error {ref['max_rel_err']} > {ref['tol']}")


# ---------------------------------------------------------------------------
# 4. times


def bound_ms(kernel, b, h, hk, s, d, dtype, causal) -> tuple:
    """The least time for the same work on this card: matmul FLOPs over the
    dtype's peak vs bytes (each input read once, each output written once)
    over HBM bandwidth. The score pairs counted are the ones the mask keeps.
    ``flash_bwd`` is the whole backward function, as one SDPA backward call
    computes it: dq, dk and dv from 5 products (S and dP once each)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    esz = 2 if dtype == "bfloat16" else 4
    q_bytes, kv_bytes, row_bytes = b * h * s * d * esz, b * hk * s * d * esz, b * h * s * 4
    n_matmuls, nbytes = {
        "flash_fwd": (2, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        "flash_bwd_dq": (3, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes),
        "flash_bwd_dkv": (4, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes),
        "flash_bwd": (5, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes + 2 * kv_bytes),
    }[kernel]
    flops = 2 * n_matmuls * b * h * pairs * d
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes


def phase_times(torch, K, A):
    import torch.nn.functional as F

    c = K.MAIN
    h, hk, causal = c["h"], c["hk"], c["causal"]
    q, k, v, do = K.make_inputs(c["b"], h, hk, c["s"], c["d"], c["dtype"], seed=2)
    sc = 1.0 / math.sqrt(c["d"])
    kw = dict(causal=causal, sm_scale=sc, h=h, hk=hk)
    o, lse = A.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    kernel_fns = {
        "flash_fwd": lambda: A.flash_fwd(q, k, v, **kw),
        "flash_bwd_dq": lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
        "flash_bwd_dkv": lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
    }
    plain_fns = {
        "flash_fwd": lambda: A._fwd_plain(q, k, v, causal, sc, h, hk),
        "flash_bwd_dq": lambda: A._bwd_dq_plain(q, k, v, do, lse, delta, causal, sc, h, hk),
        "flash_bwd_dkv": lambda: A._bwd_dkv_plain(q, k, v, do, lse, delta, causal, sc, h, hk),
    }
    # the library yardstick: one scaled_dot_product_attention call forward,
    # and its backward (dq, dk, dv together) for both backward kernels
    shape4 = (c["b"], h, c["s"], c["d"])
    q4, k4, v4 = (t.reshape(shape4).detach().requires_grad_() for t in (q, k, v))
    do4 = do.reshape(shape4)
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    lib_fwd = K.time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal))
    lib_bwd = K.time_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
    times = {}
    for name in kernel_fns:
        kms = K.time_ms(kernel_fns[name])
        pms = K.time_ms(plain_fns[name], 5, warmup=1)
        bms, by, flops, nbytes = bound_ms(name, c["b"], h, hk, c["s"], c["d"], c["dtype"], causal)
        times[name] = {"ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                       "library_ms": library[name]}
        emit({"phase": "times", "kernel": name, "shape": c, "flops": flops, "bytes": nbytes,
              **times[name], "tflops": flops / kms / 1e9})
    # like for like: one SDPA backward call computes dq, dk and dv together,
    # so the pair is held to that function's bound
    pair = {k: sum(times[n][k] for n in ("flash_bwd_dq", "flash_bwd_dkv"))
            for k in ("ms", "plain_ms")}
    bms, by, flops, nbytes = bound_ms("flash_bwd", c["b"], h, hk, c["s"], c["d"], c["dtype"],
                                      causal)
    emit({"phase": "times", "kernels": "flash_bwd_dq + flash_bwd_dkv", "shape": c, **pair,
          "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
          "tflops": flops / pair["ms"] / 1e9, "library_ms": lib_bwd,
          "ms_over_bound": pair["ms"] / bms, "ms_over_library": pair["ms"] / lib_bwd})
    return times


# ---------------------------------------------------------------------------
# 5. the slice


def phase_slice(torch, A, L, smi: str):
    """The slice as ``profile_train_step.train_slice`` builds it, so the
    profile describes the step timed here."""
    from ray_tpu_torch.tools.profile_train_step import SLICE, train_slice

    steps_timed = 3
    n_layers, batch, seq, lr = (SLICE[k] for k in ("n_layers", "batch", "seq", "lr"))
    cfg, state, step, batch_d = train_slice(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    A.reset_launch_counts()  # the main path's run starts here
    state, loss = step(state, batch_d)
    losses = [float(loss)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps_timed):
        state, loss = step(state, batch_d)
        losses.append(float(loss))  # waits for the step
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
    routes = {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS}

    steps = 1 + steps_timed
    check(all(math.isfinite(x) for x in losses), f"losses finite: {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    for name, n in launches.items():
        check(n == n_layers * steps, f"{name} launched {n} times, expected {n_layers * steps}")
        check(routes[name] == {"tensor_core": n_layers * steps, "cuda_core": 0},
              f"bf16 {name} launches by route {routes[name]}: all must take the tensor cores")
    step_s = elapsed / steps_timed
    emit({"phase": "slice", "config": f"LlamaConfig.llama2_7b(n_layers={n_layers})",
          "reduced": [f"n_layers 32 -> {n_layers}"], "params": L.param_count(cfg),
          "batch": batch, "seq": seq, "dtype": "bfloat16", "optimizer": f"adamw(lr={lr})",
          "losses": losses, "step_ms": 1e3 * step_s, "tokens_per_s": batch * seq / step_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_by_route": routes, "nvidia_smi": smi})
    return launches, routes


# ---------------------------------------------------------------------------
# 6. serve


#: the paged steps against the dense forward: f32 relative RMS bound (a
#: wrong RoPE offset, mask or gather order reads orders of magnitude above
#: it) and the bf16 bounds at full depth (relative RMS, top-1 agreements)
F32_REL_RMS = 1e-5
BF16_REL_RMS, BF16_TOP1_MIN = 0.1, 5
#: the serving configuration's engine (full width and depth of Llama-2-7B)
SERVE_ENGINE = dict(block_size=16, num_blocks=640, prefill_buckets=(64, 128, 256, 512),
                    decode_buckets=(1, 2, 4, 8), max_decode_batch=8,
                    prefix_cache_enabled=True, warmup=True)
#: the traffic: SERVE_CLIENTS threads send SERVE_REQUESTS requests in all
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_NEW_TOKENS, SHARED_PREFIX = 8, 64, 32, 512


def paged_vs_dense(torch, L, cfg, params, n_prompt, n_decode, chunk, seed):
    """One request through ``PagedModelRunner``s (prefill in chunks, then
    decode steps): one runner for each decode bucket of the serving
    configuration (1, 2, 4, 8), the request padded to the bucket, and two
    more at bucket 8 where 7 live requests with shorter prompts decode
    beside it, the request in the batch's first row or in its sixth. The request's logits at every step are held against
    ``forward`` on the same token prefix. Returns the relative RMS error
    of the batch-1 runner over all steps, the largest over the runners,
    the batch-1 runner's top-1 agreements, the step count, and two
    witnesses of how the arithmetic depends on what runs beside it: each
    runner's decode logits against batch 1's (another GEMM M; live rows
    beside it), and the last prompt token's logits recomputed alone in a
    64-row chunk (the path of a full-prompt prefix hit) against those of
    the prompt's last chunk."""
    import numpy as np
    from ray_tpu_torch.inference.model_runner import PagedModelRunner

    bs = 16
    m = -(-cfg.max_seq_len // bs)
    own = -(-(n_prompt + n_decode) // bs)  # blocks one request needs
    gen = torch.Generator().manual_seed(seed)
    lens = [n_prompt] + [n_prompt - bs * (j + 1) for j in range(7)]
    seqs = [torch.randint(1, cfg.vocab_size, (n + n_decode,), generator=gen).tolist()
            for n in lens]
    rows = [[1 + j * own + b for b in range(own)] + [0] * (m - own) for j in range(8)]
    paged = {}
    for name, batch, live, at in (("1", 1, 1, 0), ("2", 2, 1, 0), ("4", 4, 1, 0),
                                  ("8", 8, 1, 0), ("8 live", 8, 8, 0),
                                  ("8 live, row 5", 8, 8, 5)):
        runner = PagedModelRunner(cfg, params, num_blocks=max(m, 8 * own) + 1, block_size=bs,
                                  prefill_buckets=(64, chunk), decode_buckets=(batch,))
        for j in reversed(range(live)):  # the request itself last
            for s in range(0, lens[j], chunk):
                logits = runner.prefill_chunk(seqs[j][s : min(s + chunk, lens[j])], rows[j], s)
        order = list(range(1, live))
        order.insert(at, 0)  # the request's row in the batch
        steps = [logits]
        for i in range(n_decode):
            pos = [lens[j] + i for j in order]
            steps.append(runner.decode([seqs[j][p] for j, p in zip(order, pos)], pos,
                                       [rows[j] for j in order], [p + 1 for p in pos])[at])
        if name == "1":  # last: it rewrites that token's K/V
            alone = runner.prefill_chunk([seqs[0][n_prompt - 1]], rows[0], n_prompt - 1)
        paged[name] = np.stack(steps).astype(np.float64)
        del runner
    dense = []
    with torch.inference_mode():
        for n in range(n_prompt, n_prompt + n_decode + 1):
            t = torch.tensor([seqs[0][:n]], device=params.embed.device)
            dense.append(L.forward(cfg, params, t)[0, -1].cpu().numpy())
    dense = np.stack(dense).astype(np.float64)

    def rel(ours, ref):
        return float(np.sqrt(((ours - ref) ** 2).mean() / (ref ** 2).mean()))

    return {"steps": len(dense), "rel_rms": rel(paged["1"], dense),
            "rel_rms_max_over_buckets": max(rel(x, dense) for x in paged.values()),
            "top1_agree": int((paged["1"].argmax(-1) == dense.argmax(-1)).sum()),
            "decode_vs_batch1_rel_rms": {k: rel(v[1:], paged["1"][1:])
                                         for k, v in paged.items() if k != "1"},
            "last_prompt_token_alone_rel_rms": rel(alone.astype(np.float64), paged["1"][0])}


def dense_greedy(torch, L, cfg, params, prompt, n):
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n):
            t = torch.tensor([toks], device=params.embed.device)
            out.append(int(L.forward(cfg, params, t)[0, -1].argmax()))
            toks.append(out[-1])
    return out


def in_traffic(engine, reqs):
    """Every request submitted before any is read: they decode together."""
    rids = [engine.submit(prompt, **kw) for prompt, kw in reqs]
    return [list(engine.tokens(rid, timeout=300)) for rid in rids]


def alone(engine, reqs):
    """Each request sent and read before the next: each decodes at batch 1."""
    return [list(engine.generate(prompt, **kw)) for prompt, kw in reqs]


def mixed_requests(rs, vocab, n, lo, hi, new_tokens):
    """``n`` prompts of ``lo``-``hi`` tokens; even ones greedy, odd ones
    sampled at temperature 0.8 with fixed seeds."""
    return [([int(x) for x in rs.randint(1, vocab, size=rs.randint(lo, hi + 1))],
             dict(max_new_tokens=new_tokens) if i % 2 == 0 else
             dict(max_new_tokens=new_tokens, temperature=0.8, seed=2000 + i))
            for i in range(n)]


def serve_traffic(torch, engine, cfg, seed):
    """SERVE_REQUESTS requests from SERVE_CLIENTS client threads, each
    thread sending its share one after another, so SERVE_CLIENTS are in
    flight and, after the first wave, admission and decode overlap.
    Prompt lengths are drawn from 64-1024 by ``seed``; request 1 is
    request 0's 512-token prefix exactly (a full-prompt prefix hit: COW)
    and is sent once request 0's prompt is cached; even requests are
    greedy, odd ones sample at temperature 0.8 with fixed seeds. Returns
    each request's (prompt, kwargs, tokens, submit time, token arrival
    times)."""
    import threading

    import numpy as np

    rs = np.random.RandomState(seed)
    lens = rs.randint(64, 1025, size=SERVE_REQUESTS)
    lens[0] = max(lens[0], SHARED_PREFIX + 64)
    prompts = [[int(x) for x in rs.randint(1, cfg.vocab_size, size=n)] for n in lens]
    prompts[1] = prompts[0][:SHARED_PREFIX]
    kwargs = [dict(max_new_tokens=SERVE_NEW_TOKENS) if i % 2 == 0 else
              dict(max_new_tokens=SERVE_NEW_TOKENS, temperature=0.8, seed=1000 + i)
              for i in range(SERVE_REQUESTS)]
    first_cached = threading.Event()
    results = [None] * SERVE_REQUESTS
    errors = []

    def client(c):
        try:
            for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                if i == 1:
                    first_cached.wait(timeout=300)
                t0 = time.perf_counter()
                toks, times = [], []
                for tok in engine.generate(prompts[i], request_id=f"t{i}", **kwargs[i]):
                    toks.append(tok)
                    times.append(time.perf_counter())
                    if i == 0:
                        first_cached.set()
                results[i] = (prompts[i], kwargs[i], toks, t0, times)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)
            first_cached.set()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "serve traffic threads finished")
    if errors:
        raise errors[0]
    return results


def watch_blocks(engine):
    """Wraps the engine's runner so that, on the host, every block a
    prefill chunk or a decode step reads (its table row) is checked to
    belong to one running request, and every block it writes (the blocks
    under its valid positions; padding goes to the null block) to be a
    live block of exactly one running request and of no one else. Returns the list of
    violations, which fills as the engine runs."""
    runner, blocks = engine.runner, engine.blocks
    bs, m = blocks.block_size, runner.max_blocks_per_seq
    foreign = []

    def check(row, positions):
        running = [req.request_id for req in list(engine.scheduler.running)]
        owners = {}
        for rid in running:
            for b in blocks.owned(rid):
                owners.setdefault(b, set()).add(rid)
        readers = set(running)  # who owns every block the call reads
        for b in row:
            if b:
                readers &= owners.get(b, set())
        if not readers:
            foreign.append({"reads": [(b, sorted(owners.get(b, ()))) for b in row if b]})
        for p in positions:
            b = row[min(p // bs, m - 1)]
            if not b or len(owners.get(b, ())) != 1 or blocks.refcount(b) != 1:
                foreign.append({"block": b, "position": p, "owners": sorted(owners.get(b, ())),
                                "refcount": blocks.refcount(b)})

    prefill, decode = runner.prefill_chunk, runner.decode

    def checked_prefill(tokens, row, ctx_len):
        check(row, range(ctx_len, ctx_len + len(tokens)))
        return prefill(tokens, row, ctx_len)

    def checked_decode(tokens, positions, rows, ctx_lens):
        for row, p in zip(rows, positions):
            check(row, [p])
        return decode(tokens, positions, rows, ctx_lens)

    runner.prefill_chunk, runner.decode = checked_prefill, checked_decode
    return foreign


def quantiles(xs):
    import numpy as np

    return {"n": len(xs), **{f"p{q}": float(np.percentile(xs, q)) for q in (50, 90, 99)},
            "max": float(max(xs))}


def phase_serve(torch, A, L, smi: str):
    """(a) the paged steps against the dense forward (f32 at 2 layers, bf16
    at full depth), and at 2 layers in f32 the engine's streams in traffic
    against the same requests sent alone; (b) the engine serving
    concurrent requests at Llama-2-7B size; (c) the engine's byte-exact
    contracts on the tiny config in f32, requests decoding together.
    Returns the serve path's launches of each kernel."""
    import gc

    import numpy as np
    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.observability import timeline

    gc.collect()
    torch.cuda.empty_cache()  # the training slice's state is gone
    # (a) f32, 2 layers: prefill in 2 chunks, then 8 decode steps
    cfg32 = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
    p32 = L.init_params(cfg32, 1)
    r32 = paged_vs_dense(torch, L, cfg32, p32, 200, 8, 128, seed=11)
    emit({"phase": "serve", "part": "paged_vs_dense", "config":
          "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)", "tf32": False, **r32,
          "bound": F32_REL_RMS})
    for key in ("rel_rms", "rel_rms_max_over_buckets"):
        check(r32[key] <= F32_REL_RMS, f"f32 paged vs dense {key} {r32[key]} > {F32_REL_RMS}")
    # the witness for the bf16 seeded-repeat finding: in f32 a stream in
    # traffic (decode batches up to 8) equals the same request sent alone
    reqs = mixed_requests(np.random.RandomState(14), cfg32.vocab_size, 8, 16, 64, 16)
    eng = InferenceEngine(cfg32, p32, EngineConfig(
        block_size=16, num_blocks=-(-cfg32.max_seq_len // 16) + 9,
        prefill_buckets=(32, 64), decode_buckets=(1, 2, 4, 8),
        max_decode_batch=8, warmup=False)).start()
    timeline.clear_events()
    try:
        together, apart = in_traffic(eng, reqs), alone(eng, reqs)
        batches = sorted({e.args["decode_batch"] for e in timeline.timeline_events()
                          if e.name == "engine_step"})
    finally:
        eng.stop()
    dense = [dense_greedy(torch, L, cfg32, p32, p, 16) for p, kw in reqs[::2]]
    del p32
    torch.cuda.empty_cache()
    witness = {"streams": len(reqs), "decode_batches_seen": batches,
               "in_traffic_equals_alone": [a == b for a, b in zip(together, apart)],
               "greedy_in_traffic_equals_dense": together[::2] == dense}
    emit({"phase": "serve", "part": "f32_traffic_witness", "config":
          "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)", **witness})
    check(all(witness["in_traffic_equals_alone"]), "f32: streams in traffic equal streams alone")
    check(witness["greedy_in_traffic_equals_dense"], "f32: greedy in traffic equals dense")
    check(max(batches) > 1, f"f32 witness decoded several slots together: {batches}")

    # (b) the serving configuration: full width and depth, bf16
    cfg = L.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = L.init_params(cfg, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r16 = paged_vs_dense(torch, L, cfg, params, 400, 8, 256, seed=12)
    emit({"phase": "serve", "part": "paged_vs_dense", "config": "LlamaConfig.llama2_7b()",
          **r16, "bound": BF16_REL_RMS, "top1_min": BF16_TOP1_MIN})
    for key in ("rel_rms", "rel_rms_max_over_buckets"):
        check(r16[key] <= BF16_REL_RMS, f"bf16 paged vs dense {key} {r16[key]} > {BF16_REL_RMS}")
    check(r16["top1_agree"] >= BF16_TOP1_MIN,
          f"bf16 top-1 agreements {r16['top1_agree']} < {BF16_TOP1_MIN}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, params, EngineConfig(**SERVE_ENGINE))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    # the logits each sampled token of request 1 (the seeded repeat's
    # subject) was drawn from, in the traffic and in each repeat
    watched, sample = {}, engine._sample

    def recording_sample(req, logits):
        if req.request_id == "t1" or req.request_id.startswith("again"):
            watched.setdefault(req.request_id, []).append(np.array(logits, np.float64))
        return sample(req, logits)

    engine._sample = recording_sample
    foreign = watch_blocks(engine)
    engine.start()
    try:
        timeline.clear_events()
        A.reset_launch_counts()  # the serve path's run starts here
        t0 = time.perf_counter()
        results = serve_traffic(torch, engine, cfg, seed=13)
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
        steps = [e for e in timeline.timeline_events() if e.name == "engine_step"]
        engine_stats = engine.stats()
        # the same seeded request three times more, alone. The second and
        # third find its whole prompt cached, so both take one path (a
        # full-prompt hit recomputes the last prompt token alone); the
        # first may find it evicted by the traffic and prefill it whole
        prompt, kw, toks = results[1][:3]
        hits0 = engine.stats()["prefix_cache"]["hits_total"]
        again, hits = [], []
        for j in range(3):
            again += alone(engine, [(prompt, dict(kw, request_id=f"again{j}"))])
            hits.append(engine.stats()["prefix_cache"]["hits_total"] - hits0 - sum(hits))
    finally:
        engine.stop()
    peak = torch.cuda.max_memory_allocated()
    ttft = [r[4][0] - r[3] for r in results]
    itl = [b - a for r in results for a, b in zip(r[4], r[4][1:])]
    n_tokens = sum(len(r[2]) for r in results)

    def step_ms(pick):
        ms = [(e.end_us - e.start_us) / 1e3 for e in steps if pick(e.args)]
        return {"n": len(ms), "p50": float(np.percentile(ms, 50)) if ms else None}

    def lead(stream):  # how many leading tokens equal the stream in traffic
        return next((i for i, (a, b) in enumerate(zip(toks, stream)) if a != b), len(toks))

    def logits_split(rid):  # the first token whose logits differ from the traffic's
        ref = watched["t1"]
        i = next((i for i, (a, b) in enumerate(zip(ref, watched[rid]))
                  if not np.array_equal(a, b)), None)
        if i is None:
            return None
        a, b = ref[i], watched[rid][i]
        return {"token": i, "rel_rms": float(np.sqrt(((a - b) ** 2).mean() / (a ** 2).mean()))}

    emit({"phase": "serve", "part": "engine", "config": "LlamaConfig.llama2_7b()",
          "params": L.param_count(cfg), "reduced": [], "engine": SERVE_ENGINE,
          "clients": SERVE_CLIENTS, "requests": SERVE_REQUESTS,
          "new_tokens": SERVE_NEW_TOKENS, "prompt_lens": [len(r[0]) for r in results],
          "init_s": init_s, "warmup_s": warmup_s, "wall_s": wall_s,
          "ttft_s": quantiles(ttft), "itl_s": quantiles(itl),
          "generated_tokens": n_tokens, "generated_tokens_per_s": n_tokens / wall_s,
          "steps": engine_stats["total_steps"],
          "step_ms": {"with_prefill": step_ms(lambda a: a["prefill_tokens"] > 0),
                      "decode_only": step_ms(lambda a: a["prefill_tokens"] == 0),
                      "decode_only_batch8": step_ms(
                          lambda a: a["prefill_tokens"] == 0 and a["decode_batch"] == 8)},
          "seeded_repeat": {"prefix_hits": hits, "same_path_repeats_equal": again[1] == again[2],
                            "first_repeat_equals_second": again[0] == again[1],
                            "leading_tokens_equal_to_in_traffic": [lead(a) for a in again],
                            "first_logits_differing_from_traffic": [
                                logits_split(f"again{j}") for j in range(3)],
                            "preempted_total": engine_stats["scheduler"]["total_preempted"]},
          "foreign_blocks": foreign[:8], "foreign_blocks_total": len(foreign),
          "compile_count": engine.runner.compile_count(),
          "recompiles_after_warmup": engine.runner.recompiles_after_warmup(),
          "prefix_cache": engine_stats["prefix_cache"], "used_blocks": engine.blocks.used_blocks,
          "max_memory_allocated_bytes": peak, "launches": launches, "nvidia_smi": smi})
    check(all(len(r[2]) == SERVE_NEW_TOKENS for r in results),
          f"every request got {SERVE_NEW_TOKENS} tokens")
    check(engine.runner.recompiles_after_warmup() == 0, "no new shape after warmup")
    check(engine.runner.compile_count() == 4 + 4 + 1, "4 prefill + 4 decode buckets + COW")
    check(engine.blocks.used_blocks == 0, "every block returned")
    check(engine_stats["prefix_cache"]["hits_total"] >= 1, "at least one prefix hit")
    check(engine_stats["prefix_cache"]["cow_copies_total"] >= 1, "the COW path ran")
    check(hits[1:] == [1, 1], f"the last two repeats hit the prefix cache: {hits}")
    check(again[1] == again[2],
          "a seeded temperature request submitted again on the same path repeats its tokens")
    check(sum(launches.values()) == 0, f"the serve path launches no flash kernel: {launches}")
    check(not foreign, f"every block read or written belongs to its request: {foreign[:8]}")
    del engine, params
    torch.cuda.empty_cache()

    # (c) byte-exact contracts within the port: tiny config, f32, on the
    # card, every run's requests decoding together
    tiny = L.LlamaConfig.tiny()
    tp = L.init_params(tiny, 0)
    small = dict(num_blocks=64, block_size=8, prefill_buckets=(8, 32),
                 decode_buckets=(1, 2, 4), max_decode_batch=4, warmup=False)
    prompts = [[5, 9, 12, 4], [7, 7, 1, 3, 9, 2, 8, 8, 4], [1, 2, 3, 4, 5, 6, 7, 1, 2, 3]]
    shared = [12, 40, 7, 99, 3, 64, 8, 1] * 2
    greedy = [(p, dict(max_new_tokens=12)) for p in prompts]
    sampled = [(p, dict(max_new_tokens=12, temperature=0.8, seed=300 + i))
               for i, p in enumerate(prompts)]
    prefixed = [(p, dict(max_new_tokens=12)) for p in (shared + [5], shared, shared + [6, 2])]
    runs = {}
    for name, extra, reqs in (
        ("plain", {}, greedy + sampled), ("speculative", {"speculative_k": 4}, greedy + sampled),
        ("prefix_on", {}, prefixed), ("prefix_off", {"prefix_cache_enabled": False}, prefixed),
    ):
        eng = InferenceEngine(tiny, tp, EngineConfig(**small, **extra)).start()
        try:
            runs[name] = in_traffic(eng, reqs)
            if name == "plain":
                runs["sampled_alone"] = alone(eng, sampled)
            if name == "speculative":
                proposed = eng.stats()["speculative"]["proposed_tokens"]
        finally:
            eng.stop()
    dense = [dense_greedy(torch, L, tiny, tp, p, 12) for p in prompts]
    contracts = {"greedy_equals_dense": runs["plain"][:3] == dense,
                 "sampled_in_traffic_equals_alone": runs["plain"][3:] == runs["sampled_alone"],
                 "speculative_equals_plain": runs["speculative"] == runs["plain"],
                 "speculative_proposed": proposed,
                 "prefix_equals_no_prefix": runs["prefix_on"] == runs["prefix_off"]}
    emit({"phase": "serve", "part": "contracts", "config": "LlamaConfig.tiny() f32 on cuda",
          "requests_together": {"plain": 6, "speculative": 6, "prefix": 3}, **contracts})
    for what in ("greedy_equals_dense", "sampled_in_traffic_equals_alone",
                 "speculative_equals_plain", "prefix_equals_no_prefix"):
        check(contracts[what], what)
    check(proposed > 0, "the speculative engine proposed drafts")
    return launches


# ---------------------------------------------------------------------------
# 7. serve_llm: the in-process serving surface


#: (a)/(b): f32 at 2 layers; (c)/(d): the serving configuration, whose
#: health check reads a step stalled for over a second
LLM_F32_ENGINE = dict(block_size=16, num_blocks=288, prefill_buckets=(64, 256),
                      decode_buckets=(1, 2, 4), max_decode_batch=4, warmup=False)
LLM_BF16_ENGINE = dict(SERVE_ENGINE, step_stall_unhealthy_s=1.0)
#: the speculative survivor's draft model (a draft model proposes at every
#: step; random weights leave n-gram lookup nothing to find)
LLM_DRAFT = dict(dim=256, n_layers=1, n_heads=4, n_kv_heads=4, mlp_hidden=512)
RESUME_K, CUT_K = (1, 5, 11), (1, 5, 11, 20)
CHAOS_SPEC, CHAOS_SEED, STALL_SPEC = "kill_mid_decode:1.0:6", 20260804, "stall:1.0:3.0:1"


def flat(chunks):
    """A stream of TokenChunk bursts flattened, as the serve router does."""
    return [item for chunk in chunks for item in chunk]


def gated(gate, pairs, out):
    """Admits ``(seq, token)`` pairs through a SeqGate into ``out``."""
    for seq, tok in pairs:
        if gate.admit(seq):
            out.append(tok)


def resume_f32(torch, L, smi):
    """(a) every request streamed undisturbed on server A, then resumed at
    each k on a plain survivor B and a speculative survivor C (all three
    built from one seed); the delivered-EOS and room-clamped resumes; (b)
    the same request streamed by a child replica armed with
    ``kill_mid_decode`` and resumed on B behind a SeqGate."""
    import gc

    import numpy as np
    from ray_tpu_torch.core.streaming import SeqGate
    from ray_tpu_torch.inference import EngineConfig, LLMServer
    from ray_tpu_torch.tools.chaos_stream import stream_in_child

    t0 = time.perf_counter()
    cfg = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
    spec = dict(speculative_k=3, speculative_draft="model",
                draft_config=L.LlamaConfig.llama2_7b(**LLM_DRAFT, dtype=torch.float32))
    a, b, c = (LLMServer(cfg, EngineConfig(**LLM_F32_ENGINE, **extra), seed=1)
               for extra in ({}, {}, spec))
    rs = np.random.RandomState(21)
    prompts = [[int(x) for x in rs.randint(1, cfg.vocab_size, size=n)] for n in (40, 100, 190, 48)]
    reqs = [dict(prompt=p, max_new_tokens=16, request_id=f"a{i}",
                 **({} if i % 2 == 0 else dict(temperature=0.8, seed=700 + i)))
            for i, p in enumerate(prompts)]
    undisturbed = [flat(a.generate({**r, "resume_from": 0})) for r in reqs]
    tails = {}
    for i, (r, full) in enumerate(zip(reqs, undisturbed)):
        toks = [t for _, t in full]
        for k in RESUME_K:
            for name, survivor in (("plain", b), ("speculative", c)):
                got = flat(survivor.generate({**r, "request_id": f"{name}{i}-{k}",
                                              "prompt": r["prompt"] + toks[:k], "resume_from": k}))
                tails[f"{i}/{k}/{name}"] = got == full[k:]
    toks = [t for _, t in undisturbed[0]]
    eos_resume = flat(b.generate({**reqs[0], "request_id": "eos", "prompt": reqs[0]["prompt"]
                                  + toks[:5], "eos_token": toks[4], "resume_from": 5}))
    n = cfg.max_seq_len
    clamped = flat(b.generate({"prompt": list(range(1, n - 3)) + toks[:4], "max_new_tokens": 10,
                               "resume_from": 4, "request_id": "clamped"}))
    part_a = {"phase": "serve_llm", "part": "a_resume_f32",
              "config": "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)",
              "reduced": ["n_layers 32 -> 2"], "tf32": False, "engine": LLM_F32_ENGINE,
              "speculative_survivor": {"k": 3, "draft": f"llama2_7b({LLM_DRAFT}) f32"},
              "requests": [{"prompt_len": len(r["prompt"]), "temperature": r.get("temperature", 0.0)}
                           for r in reqs],
              "undisturbed_seqs_ok": all([s for s, _ in f] == list(range(16)) for f in undisturbed),
              "tails_equal": tails, "delivered_eos_resume": eos_resume,
              "room_clamped_resume": clamped,
              "speculative_proposed": c.engine_stats()["speculative"]["proposed_tokens"],
              "metrics_address": a.metrics_address(), "seconds": time.perf_counter() - t0}
    emit(part_a)
    check(part_a["undisturbed_seqs_ok"], "undisturbed streams number their tokens 0-15")
    check(all(tails.values()), f"f32 resumed tails equal the undisturbed streams: {tails}")
    check(eos_resume == [] and clamped == [], "delivered-EOS and room-clamped resumes yield nothing")
    check(part_a["speculative_proposed"] > 0, "the speculative survivor proposed drafts")
    check(part_a["metrics_address"] is not None, "LLMServer exports its metrics")

    # (b) the same f32 server in a child process, SIGKILLed mid-decode
    t0 = time.perf_counter()
    r = reqs[1]
    delivered, rc, err = stream_in_child(
        r, CHAOS_SPEC, CHAOS_SEED, timeout=300, model="llama2_7b", n_layers=2,
        dtype="float32", device="cuda", seed=1, engine=LLM_F32_ENGINE)
    gate, stream = SeqGate(), []
    gated(gate, delivered, stream)
    k = len(stream)
    gated(gate, flat(b.generate({**r, "request_id": "after-kill",
                                 "prompt": r["prompt"] + stream, "resume_from": k})), stream)
    part_b = {"phase": "serve_llm", "part": "b_kill_f32", "spec": CHAOS_SPEC,
              "chaos_seed": CHAOS_SEED, "child_returncode": rc, "delivered_before_kill": k,
              "child_log": [line for line in err.splitlines() if "chaos" in line][-2:],
              "stream_len": len(stream), "next_seq": gate.next_seq,
              "equals_undisturbed": stream == [t for _, t in undisturbed[1]],
              "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part_b)
    check(rc == -9, f"the child replica died by SIGKILL (rc {rc}): {err[-2000:]}")
    check(1 <= k < 16, f"the kill landed mid-stream after {k} tokens")
    check(part_b["equals_undisturbed"] and gate.next_seq == 16,
          "the resumed stream has no gap, no repeat, and equals the undisturbed one")
    del a, b, c
    gc.collect()
    torch.cuda.empty_cache()


def stall_and_resume_bf16(torch, L, smi):
    """(c) a stall armed on one of two servers sharing Llama-2-7B's params:
    unhealthy while it sleeps, healthy after, the same tokens as the
    unarmed server; (d) 8 requests from 8 client threads, undisturbed on
    X, then each cut after k tokens on Y by closing its stream and resumed
    on X."""
    import gc
    import threading

    import numpy as np
    from ray_tpu_torch.core.streaming import SeqGate
    from ray_tpu_torch.inference import EngineConfig, LLMServer

    cfg = L.LlamaConfig.llama2_7b()
    params = L.init_params(cfg, 0)
    t0 = time.perf_counter()
    x, y = (LLMServer(cfg, EngineConfig(**LLM_BF16_ENGINE), params=params) for _ in range(2))
    warmup_s = time.perf_counter() - t0
    # (c) the stall
    t0 = time.perf_counter()
    rs = np.random.RandomState(31)
    req = {"prompt": [int(t) for t in rs.randint(1, cfg.vocab_size, size=200)],
           "max_new_tokens": 16}
    x.testing_arm_replica_chaos(STALL_SPEC, 1)
    out, readings, errors = [], [], []

    def send():
        try:
            out.extend(x(req)["tokens"])
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    sent = time.perf_counter()
    th = threading.Thread(target=send)
    th.start()
    while th.is_alive():
        readings.append((time.perf_counter() - sent, x.check_health()))
        time.sleep(0.05)
    th.join(timeout=300)
    if errors:
        raise errors[0]
    want = y(req)["tokens"]
    unhealthy = [t for t, ok in readings if not ok]
    part_c = {"phase": "serve_llm", "part": "c_stall_bf16", "config": "LlamaConfig.llama2_7b()",
              "spec": STALL_SPEC, "step_stall_unhealthy_s": 1.0, "readings": len(readings),
              "first_unhealthy_s": unhealthy[0] if unhealthy else None,
              "last_unhealthy_s": unhealthy[-1] if unhealthy else None,
              "request_s": readings[-1][0] if readings else None,
              "healthy_after": x.check_health(),
              "injections": x.engine.testing_fault_plan.injections,
              "tokens_equal_unarmed": out == want, "warmup_s_two_servers": warmup_s,
              "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part_c)
    check(unhealthy and part_c["healthy_after"], "unhealthy during the stall, healthy after")
    check(part_c["injections"] == 1, "the stall was injected once")
    check(part_c["tokens_equal_unarmed"], "the stalled request's tokens equal the unarmed server's")

    # (d) cut and resumed at full size, 8 client threads
    t0 = time.perf_counter()
    n_req, new = 8, 32
    lens = rs.randint(64, 1025, size=n_req)
    reqs = [dict(prompt=[int(t) for t in rs.randint(1, cfg.vocab_size, size=n)],
                 max_new_tokens=new, **({} if i % 2 == 0 else dict(temperature=0.8, seed=900 + i)))
            for i, n in enumerate(lens)]
    cold, cut, errors = [None] * n_req, [None] * n_req, []
    # the logits X samples each token of the undisturbed ("u") and the
    # resumed ("r") streams from: where a resumed tail splits, and by how much
    watched, sample = {}, x.engine._sample

    def recording_sample(req, logits):
        watched.setdefault(req.request_id, []).append(np.array(logits, np.float64))
        return sample(req, logits)

    x.engine._sample = recording_sample

    def in_threads(fn):
        threads = [threading.Thread(target=fn, args=(i,)) for i in range(n_req)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads), "client threads finished")
        if errors:
            raise errors[0]

    def undisturbed(i):
        try:
            t, first, pairs = time.perf_counter(), None, []
            for chunk in x.generate({**reqs[i], "request_id": f"u{i}", "resume_from": 0}):
                first = first or time.perf_counter()
                pairs += chunk
            cold[i] = (pairs, first - t)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    def cut_and_resume(i):
        try:
            k, gate, stream = CUT_K[i % len(CUT_K)], SeqGate(), []
            gen = y.generate({**reqs[i], "request_id": f"c{i}", "resume_from": 0})
            for chunk in gen:
                gated(gate, chunk[: k - len(stream)], stream)
                if len(stream) == k:
                    break
            gen.close()  # the client goes away: the request is cancelled
            t = time.perf_counter()
            first = None
            for chunk in x.generate({**reqs[i], "request_id": f"r{i}", "resume_from": k,
                                     "prompt": reqs[i]["prompt"] + stream}):
                first = first or time.perf_counter()
                gated(gate, chunk, stream)
            cut[i] = (k, stream, gate.next_seq, first - t)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    in_threads(undisturbed)
    in_threads(cut_and_resume)
    for s in (x, y):
        s.engine.wait_idle(60)
    per_request = []
    for i, ((pairs, _), (k, stream, next_seq, _)) in enumerate(zip(cold, cut)):
        ref = [t for _, t in pairs]
        diff = next((j for j, (p, q) in enumerate(zip(ref, stream)) if p != q), None)
        u, r = watched[f"u{i}"][k], watched[f"r{i}"][0]
        per_request.append({"prompt_len": int(lens[i]), "k": k,
                            "temperature": reqs[i].get("temperature", 0.0),
                            "tokens": len(stream), "next_seq": next_seq,
                            "delivered_equal": stream[:k] == ref[:k],
                            "tail_equal": sum(p == q for p, q in zip(ref[k:], stream[k:])),
                            "first_differing_position": diff,
                            "first_resumed_logits_rel_rms":
                                float(np.sqrt(((u - r) ** 2).mean() / (u ** 2).mean()))})
    compiles = {n: s.engine.runner.recompiles_after_warmup() for n, s in (("x", x), ("y", y))}
    used = {n: s.engine.blocks.used_blocks for n, s in (("x", x), ("y", y))}
    part_d = {"phase": "serve_llm", "part": "d_resume_bf16", "config": "LlamaConfig.llama2_7b()",
              "reduced": [], "engine": LLM_BF16_ENGINE, "clients": n_req, "new_tokens": new,
              "requests": per_request,
              "byte_exact": sum(r["first_differing_position"] is None for r in per_request),
              "ttft_cold_s": quantiles([c[1] for c in cold]),
              "ttft_resume_s": quantiles([c[3] for c in cut]),
              "recompiles_after_warmup": compiles, "used_blocks": used,
              "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part_d)
    check(all(r["tokens"] == new and r["next_seq"] == new for r in per_request),
          f"every resumed stream ends with {new} tokens, seq numbers contiguous")
    check(compiles == {"x": 0, "y": 0}, f"no new shape after warmup: {compiles}")
    check(used == {"x": 0, "y": 0}, f"every block of both servers came back: {used}")
    del x, y, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_llm(torch, A, L, smi: str):
    """The in-process serving surface: LLMServer's seq-numbered resume in
    f32 (a), a child replica killed mid-decode and resumed (b), a stalled
    step read by the health check (c), and streams cut and resumed at
    full Llama-2-7B in bf16 (d). Returns the path's launches of each
    kernel (it has none)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the serve phase's engines and caches are gone
    A.reset_launch_counts()  # the serve_llm path's run starts here
    resume_f32(torch, L, smi)
    stall_and_resume_bf16(torch, L, smi)
    launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
    emit({"phase": "serve_llm", "part": "launches", "launches": launches})
    check(sum(launches.values()) == 0, f"the serve_llm path launches no flash kernel: {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.tools import kernel_check as K

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "nvidia_smi": smi, "name": name, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build(torch)
    errs = phase_parity(K, A)
    phase_reference(K, L)
    times = phase_times(torch, K, A)
    launches, routes = phase_slice(torch, A, L, smi)
    phase_serve(torch, A, L, smi)
    phase_serve_llm(torch, A, L, smi)
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": TPU_KERNELS[k][1], "replaces_fn": TPU_KERNELS[k][0],
         "launches": launches[k], "max_abs_err": errs[k], **times[k],
         "launches_by_route": routes[k]}
        for k in SOURCES
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
