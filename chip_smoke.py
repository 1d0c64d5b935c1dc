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
   tensor-core route.

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
