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
8. runtime (the earlier phases' engines freed first): the port's own
   cluster (``ray_tpu_torch.init(num_cpus=4)``, no resources given) on
   the card. (a) the node daemon must detect one GPU, and a CPU task must
   see ``CUDA_VISIBLE_DEVICES=""`` and no device; (b) once that task's
   lease is back, a ``num_gpus=1`` task must land on the same pooled
   worker, promoted to GPU 0 (the card named as the driver's), find the
   kernel library built by phase 1 cached, run the three kernels once
   each at the main case's shapes (all on the tensor cores) within
   ``kernel_check.compare``'s bounds of their plain versions, and return
   ``o``, which must arrive as a CPU bf16 tensor with the bits the task
   hashed; a worker whose ``torch.cuda.init()`` failed under the pin must
   be refused a GPU lease and retired, and the lease must go to a worker
   that can use the card; (c) while a ``num_gpus=1`` actor lives a second
   ``num_gpus=1`` task must stay pending (2 s), run once the actor is
   killed, and the GPU must be free again after; (d) a ``num_gpus=1``
   actor around ``LLMServer`` (``generate`` streamed through the
   runtime): in f32 at 2 layers with TF32 off its 4 streams (2 greedy, 2
   seeded at 0.8, 16 tokens) must equal an in-process server's from the
   same seed byte for byte; then at full Llama-2-7B in bf16
   (``SERVE_ENGINE``) 16 requests from 4 client threads (prompts of
   64-1024 tokens, 32 new, half greedy) must all finish with every block
   back and no shape after warmup; it prints TTFT, ITL and generated
   tokens/s beside the ``serve`` phase's, and the actor's init seconds
   and peak memory read inside it; (e) after ``shutdown()`` no process of
   the cluster may survive (the port's reaper scan).
9. serve_deployment (the flash kernels' counts set to 0 before it and
   read after, in this process and in every replica, all 0): a fresh
   cluster of the port's (``ray_tpu_torch.init(num_cpus=4)``) and
   ``serve.llm_deployment(..., ray_actor_options={"num_gpus": 1})``
   behind ``serve.run``. (a) f32 at 2 layers: the replica must hold GPU 0
   (``LLMServer.testing_device_info()``, read inside it) while the serve
   controller was spawned with ``CUDA_VISIBLE_DEVICES=""``, and its 4
   streams (2 greedy, 2 seeded at 0.8, 16 tokens) through
   ``handle.stream(..., _method="generate")`` must equal an in-process
   server's from the same seed byte for byte; a replica with no GPU lease
   must fail to build ("no CUDA device"); (b) ``kill_mid_decode:1.0:6``
   armed on that replica through the handle: the stream, resumed by the
   router on the controller's replacement, must equal the undisturbed
   one, the controller must count one ``death`` restart, and the
   replacement must hold GPU 0 (it prints the gap from the last token
   before the kill to the first after it); (b') a tiny f32 deployment
   bound ``params=`` made in this process (they reach the replica as host
   tensors) must serve on ``cuda:0`` and stream what an in-process server
   streams on those params; (c) full Llama-2-7B in bf16
   (``SERVE_ENGINE``, seed 0) answering the ``serve`` phase's traffic
   (64 requests from 8 client threads) through the handle: all 64 with 32
   tokens and no resume, every block back, no shape after warmup, a
   prefix hit and a COW; it prints TTFT, ITL, TPOT and generated tokens/s
   beside the ``serve`` phase's, and the replica's init seconds and peak
   memory; then one greedy request over HTTP must get 32 tokens; (d)
   ``begin_drain(30.0)`` through the handle with 4 streams live: each
   must end with 32 tokens and no error, and the engine must read
   draining with nothing running and every block back; (e) after
   ``serve.shutdown()`` and ``shutdown()`` no process of the cluster may
   survive. It returns (b)'s gap for the next phase to print beside its own.
   Phase ingress rides this cluster (its lines say ``"phase": "ingress"``;
   the flash kernels' counts from before its (a) to after its (b), in this
   process and every replica, are its own and must be 0; each door replica
   is a CPU deployment, ``num_cpus=0.1``, spawned with
   ``CUDA_VISIBLE_DEVICES=""`` and never mapping ``libcuda.so``). (a),
   after (b') while its replica is live: ``ingress_deployment`` with the
   tenants of ``tests/test_ingress.py`` in front of it; (b')'s requests
   through ``http_stream`` must equal the in-process server's streams
   byte for byte; a 48-token stream closed after 2 tokens must bring the
   engine back to nothing running and every block back within 30 s,
   admitted once; 12 requests of the abusive tenant (cost 12, burst 50)
   must give at least one 200 and one 429, every 429 ``rate_limit`` with
   ``Retry-After > 0``, the engine's admissions growing by exactly the
   200s and ``serve.status()``'s ``shed_total`` by the 429s; a malformed
   body gets 400; ``serve.slo_report()``'s ingress and engine books
   balance. (b), after (c) while the 7B replica is live: a door with the
   trace's tenants on the default buckets and one abusive tenant (rate
   100, burst 400) replays ``INGRESS_SPEC`` through
   ``loadgen.run_trace(..., addresses=...)`` while 40 abusive requests
   (64-token prompts, 16 new tokens) arrive at 10 a second: every request
   must come back ok or shed, every shed with a reason and
   ``Retry-After > 0``, the abuser shed, the door's ok + shed equal to
   what was sent and its forwards to the engine's admissions, the books
   balanced; it prints TTFT p50/p99 on the client's clock beside the
   door's TTFB and the TTFT of the door's router and of the engine, ITL,
   tokens/s, sheds by class and reason, ``loadgen.score``'s attainment
   (TTFT 2 s, ITL 0.5 s) and the repro line.
10. kv_migration (the flash kernels' counts set to 0 before it and read
   after, in this process and in every replica, all 0): KV migration and
   the cluster KV tier. (a) f32 at 2 layers, no cluster: 8 requests (4
   greedy, 4 seeded at 0.8, prompts of 40-200 tokens, none a whole number
   of blocks), each exported by one ``LLMServer`` (``prefill_export``)
   and streamed by another with the descriptor as ``kv_import``, must
   equal a plain server's stream byte for byte, with the importer's
   prefix hit covering the descriptor's tokens, 8 transfers and no
   fallback; a descriptor with a wrong host type, element type or digest
   must be refused, counted, and still give the plain stream; (b) full
   Llama-2-7B in bf16, the driver on a fresh cluster of the port's (so
   the payload goes through the node daemon's shared memory): 16
   requests (prompts of 256-1024 tokens) exported by A, imported by B,
   and sent cold to C, three servers sharing one params object
   (``SERVE_ENGINE`` with ``kv_transfer_enabled``): the migration used in
   16 of 16 with no fallback, every block back, no shape after warmup; it
   prints per request and as p50/max the blocks and bytes moved, the
   ``kv_export`` ledger stage, publish, fetch and ``kv_import`` ms, GB/s
   each way, B's TTFT after the handoff against C's cold TTFT, and how
   many streams equal the cold one (bf16: reported, not gated); (c)
   ``llm_deployment(kv_tier=True)``, one ``num_gpus=1`` replica in f32 at
   2 layers: ``kill_mid_decode`` under 4 streams sharing a 3-block
   prefix: the streams equal the undisturbed ones, the replacement
   adverts the shared chain it recovered from the daemon's registry,
   faults tier blocks in and admits every resumed stream with its prefix
   warm (it prints the kill-to-first-resumed-token gap beside phase 9's);
   then that replica is unrouted (scaled to 0) and drained with
   ``migrate=True`` under 2 live streams, one decoding and one
   mid-prefill under a 0.5 s stall: the mid-prefill stream's written
   blocks must reach the tier, the controller reaps the replica, the
   deployment scales back to 1, and both streams finish on the new
   replica equal to the undisturbed ones, the decoding one by fault-in.
11. train (the earlier phases' engines freed first): the training path as
   a user reaches it, on a fresh cluster of the port's. (a) tiny Llama in
   f32 with TF32 off through ``TorchTrainer`` (one GPU worker,
   ``TorchBackendConfig(mesh_spec=MeshSpec(fsdp=-1), sharding="fsdp")``,
   ``tools/train_llama.py``'s loop: ``init_sharded``, the rule-constrained
   step with ``remat="selective"``, seeded numpy tokens through
   ``get_dataset_shard("train").iter_device_batches``), 8 steps with a
   checkpoint of model and optimizer state every 2 (``num_to_keep=2``),
   the worker dying before step 5 on its first attempt and the gang
   restarted (``max_failures=1``): the 8 losses must equal the same step
   run uninterrupted in this process on a world-1 nccl mesh within 1e-6
   relative, two checkpoints must be kept, and the worker must see one
   GPU (its leased ``CUDA_VISIBLE_DEVICES``) and an nccl group; (b) phase
   ``slice``'s config, params and batch through the trainer (nccl world
   1, fsdp rules, selective remat), 1 warm and 3 timed steps: the loss
   finite and falling, each of the 4 losses within 2^-8 of phase
   ``slice``'s on the same batch (the last three follow updates),
   and inside the worker each kernel launched n_layers x 4 times, all on
   the tensor cores; it prints step ms, tokens/s and the worker's peak
   memory beside phase ``slice``'s step ms; (c) phase ``slice``'s step in
   this process under ``remat=False``, ``"selective"`` and ``"full"``, 2
   steps each: the forward kernel launched n_layers, n_layers and 2 x
   n_layers times a step, dq and dk/dv n_layers times, both steps'
   losses equal within 2^-8 across modes (the second follows an update,
   so it holds each mode's backward); it prints each mode's step ms and
   peak memory.
12. moe (the training state freed first): MoE FFNs in the flagship step.
   (a) tiny f32 with TF32 off: ``moe_ffn`` on the card against the same
   call on CPU copies of its inputs, uncapped and at capacity factor 0.5
   (``out`` and ``aux_loss`` within 1e-5, the dropped fraction equal, none
   dropped uncapped), and 3 steps of ``LlamaConfig.tiny(moe_experts=4)``
   through the kernels against the plain attention (losses within 1e-5
   relative); (b) ``LlamaConfig.llama2_7b(moe_experts=8, n_layers=4)``
   (4,859,269,120 parameters, capacity 1,280 slots an expert) on phase
   ``slice``'s batch with AdamW and selective remat, 1 warm and 3 timed
   steps: the loss finite and falling, each kernel launched n_layers
   times a step, all on the tensor cores; it prints step ms, tokens/s and
   peak memory beside ``slice``'s step ms, the summed aux loss and each
   layer's dropped fraction per step, and one profiled step's device ms
   in four groups (dispatch/combine einsums, expert GEMMs, flash kernels,
   the rest) with its idle share; (c) (b)'s model from the same seed under
   ``tp_rules`` on a world-1 nccl mesh, 2 steps: both losses within 2^-8
   of (b)'s first two, step ms printed.
13. seq_parallel: (a) ``ring_attention_sharded`` and
   ``ulysses_attention_sharded`` on a world-1 nccl mesh in f32 (GQA),
   outputs and q/k/v gradients within 1e-5 of ``reference_attention``;
   (b) phase ``slice``'s config, params and batch with
   ``attention_impl="ulysses"`` and ``"ring"`` through
   ``make_train_step(mesh=<world-1 mesh>, remat="selective")`` with no
   rules, 2 steps each: Ulysses' losses within 2^-8 of ``slice``'s and
   each kernel launched n_layers times a step on the tensor cores; the
   ring's within 2^-6 (its chunks are f32 einsums) and no kernel launched;
   each step ms printed beside ``slice``'s.
14. rl (imports no ``gymnasium``: the card's machine has none): (a)
   ``apply_cnn_q`` and ``apply_cnn_policy`` at Atari width (seeded uint8
   frames ``[256, 84, 84, 4]``, 6 actions; XLA's asymmetric SAME padding)
   and the MLP policy and Q nets at CartPole's 4-dim obs, on the card
   against the same functions on the CPU (f32, TF32 off, within 1e-5 of
   the largest reference value), the Q-net with bf16 params on bf16
   frames against f32 (relative RMS within 2^-6), and the Q-net's
   images/s in f32 and bf16 beside the bound; (b) the learners on the card
   against the same learners on the CPU, f32 with TF32 off, each update
   held on its own (the CPU learner put at the card's state before it):
   32 DQN double-Q updates of the CNN Q-net at 84x84x4, batch 64 from a
   ``ReplayBuffer`` of seeded transitions, with two target syncs inside
   the run; one PPO iteration's updates (4 epochs over 512 rows in
   minibatches of 256); 4 IMPALA V-trace updates on ``[8, 64]`` batches;
   stats within 1e-4 relative and params within 5% of lr, update ms
   printed; IMPALA's ``compute_single_action`` runs its policy on the
   card for the card's learner, with the CPU learner's action; (c) the port's cluster (``ray_tpu_torch.init(num_cpus=4)``,
   which must detect the card) and a one-learner ``LearnerGroup`` with
   ``resources_per_learner={"GPU": 1}``: the learner holds the GPU, sees
   ``cuda`` through ``CUDA_VISIBLE_DEVICES="0"``, and its IMPALA stats on
   (b)'s batches equal (b)'s card run within 1e-6 relative; the GPU comes
   back after, and no process of the cluster survives shutdown.
15. pipeline: ``pipeline_apply`` over phase ``slice``'s config, params
   and batch on a world-1 nccl mesh (stage axis 1: the whole schedule runs,
   its shifts copies on the one rank, its sum an all-reduce over it), all layers in the one stage, the batch as 2 microbatches of ``[1, 2048, 4096]``: the forward
   equal to the layer loop on the same microbatches and within 2^-8
   relative RMS of the loop over the whole batch; the layer gradients of
   a seeded cotangent within 2^-8 relative norm of both loops'; the
   forward kernel launched n_layers x 2 times in the forward, dq and dk/dv
   n_layers x 2 each in the backward, all on the tensor cores; its ms
   printed beside the loops'.
16. tune, on a fresh cluster of the port's (which must detect the card):
   (a) a function trainable over phase ``slice``'s config, seed and batch
   at slice's lr and 100x, ``resources_per_trial={"CPU": 1, "GPU":
   1}``, one trial at a time, 4 steps at most under ASHA (rungs at 1 and
   2 steps): each trial's actor sees the card as GPU 0, each step
   launches each kernel n_layers times on the tensor cores, the slice-lr
   trial's losses are within 2^-8 of ``slice``'s, every trial's status is
   the one ASHA's rule gives on the reported losses (replayed here), and
   a 10 ms sampler sees the GPU held in one spell a trial, free between;
   (b) ``TorchTrainer`` over ``llama_train_loop`` at train (b)'s config as
   the trainable, lr 1x and 10x: each trial's worker an nccl group of
   world 1 on GPU 0, n_layers x 4 tensor-core launches a kernel, the best
   trial the one with the lowest final loss, the lr-1x losses within 2^-8
   of train (b)'s, one GPU spell a trial; it prints each trial's seconds
   and step ms; no process of the cluster survives.
17. job: ``start_job_server`` and ``JobSubmissionClient`` on a fresh
   cluster. (i) ``python -m ray_tpu_torch.tools.train_llama`` submitted as
   a job trains 2 steps of ``slice``'s model through ``TorchTrainer``: it
   must succeed, its logs (``tail_job_logs``) must hold losses within 2^-8
   of ``slice``'s, its entrypoint must see ``CUDA_VISIBLE_DEVICES=""`` and
   its worker the card; (ii) a tiny f32 training job stopped while its
   worker holds the GPU must read STOPPED, the GPU must come back, and
   the entrypoint and the worker must be gone.
18. autoscaler: a GPU-less head (``{"GPU": 0}``), ``StandardAutoscaler``
   over ``FakeMultiNodeProvider`` with one ``{"CPU": 1, "GPU": 1}`` node
   type: a pending ``num_gpus=1`` task makes it launch one node, where the
   task runs the three kernels at the main case against their plain
   versions on GPU 0; the idle node is terminated after its 3 s timeout,
   its daemon and worker gone; it prints seconds from demand to the
   task's start and from idle to termination.
19. cli: ``python -m ray_tpu_torch.scripts start --head`` (its PID files
   under a ``TMPDIR`` of its own): ``status`` lists one node and ``GPU:
   1/1``, ``list nodes`` shows it, a driver on that address runs a
   ``num_gpus=1`` task running the kernels against their plain versions,
   and ``stop`` stops 1 daemon and leaves no process of the port's.
20. dag, on a fresh cluster of the port's (which must detect the card):
   compiled graphs. (a) a two-stage compiled pipeline: a ``num_gpus=1``
   actor builds ``LlamaConfig.llama2_7b(n_layers=2)`` in bf16 from seed 0
   and returns the last position's logits on the card; the shm channel
   stages them to the host for a CPU actor (``CUDA_VISIBLE_DEVICES=""``),
   which returns the argmax with the logits. 16 executions of seeded
   ``[1, 512]`` prompts are in flight before the first get, then 8 run
   one at a time: each output within 2^-8 of the largest logit of the
   same ``forward`` run here on the card from the same seed (expected
   0.0), each token its logits' argmax and the driver's wherever the
   driver's top-2 margin exceeds twice the largest difference, and the
   GPU stage launching the forward kernel twice an execution, all on the
   tensor cores; (b) ``with_tensor_transport("device")`` between two
   methods of the GPU actor: the consumer gets the producer's CUDA tensor
   itself, no channel is made for that edge, and the tokens equal (a)'s;
   a device edge into the CPU actor is refused at compile with the
   reference's message; (c) the GPU is free once the actors are killed
   and no process survives shutdown; (d) it prints p50 ms per execution
   compiled against the same two calls through ``.remote()`` and ``get``.
   Then the script's total seconds.

Then the ``kernels`` summary line (each kernel's launches on the main path
and in phases pipeline, tune, job, autoscaler, dag and ingress), the ``nvidia-smi``
line, and last the
``{"ok": true, "device": ...}`` line. Any failed check raises: the script
then exits non-zero without the last line. Without a CUDA device it exits
non-zero before printing anything.
"""

from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()

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
    return launches, routes, {"losses": losses, "step_ms": 1e3 * step_s}


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

    if not xs:
        return {"n": 0}
    return {"n": len(xs), **{f"p{q}": float(np.percentile(xs, q)) for q in (50, 90, 99)},
            "max": float(max(xs))}


#: gaps shorter than this between two tokens of a stream put them in one
#: burst: a decode step of the 7B model takes tens of ms, so a shorter gap
#: means the reader took tokens that were already waiting
BURST_GAP_S = 1e-3


def stream_timing(arrivals):
    """Inter-token timing of streams, given each stream's token arrival
    times. A reader that lags a step takes several tokens at once (a
    chunk, or tokens already queued), so their gaps are near 0 and pull
    the ITL quantiles down. Beside those quantiles stand the share of such
    gaps, the number of bursts, the gaps between bursts, and each
    request's time per output token (TPOT: its first to its last token,
    over the tokens after the first), which no coalescing biases."""
    gaps = [b - a for ts in arrivals for a, b in zip(ts, ts[1:])]
    between = [g for g in gaps if g >= BURST_GAP_S]
    return {"itl_s": quantiles(gaps),
            "itl_gaps_in_bursts_share": (len(gaps) - len(between)) / len(gaps) if gaps else None,
            "bursts": len(arrivals) + len(between),
            "itl_between_bursts_s": quantiles(between),
            "tpot_s": quantiles([(ts[-1] - ts[0]) / (len(ts) - 1)
                                 for ts in arrivals if len(ts) > 1])}


def step_breakdown(steps):
    """p50 engine step times (ms) of ``(ms, prefill tokens, decode batch)``
    steps: those with a prefill chunk, decode-only ones, and decode-only
    ones by decode batch."""
    import numpy as np

    def p50(ms):
        return {"n": len(ms), "p50": float(np.percentile(ms, 50)) if ms else None}

    decode = [st for st in steps if st[1] == 0]
    return {"with_prefill": p50([st[0] for st in steps if st[1] > 0]),
            "decode_only": p50([st[0] for st in decode]),
            "decode_only_by_batch": {b: p50([st[0] for st in decode if st[2] == b])
                                     for b in sorted({st[2] for st in decode})}}


def engine_steps():
    """This process's ``engine_step`` timeline events as ``(ms, prefill
    tokens, decode batch)``."""
    from ray_tpu_torch.observability import timeline

    return [((e.end_us - e.start_us) / 1e3, e.args["prefill_tokens"], e.args["decode_batch"])
            for e in timeline.timeline_events() if e.name == "engine_step"]


def phase_serve(torch, A, L, smi: str):
    """(a) the paged steps against the dense forward (f32 at 2 layers, bf16
    at full depth), and at 2 layers in f32 the engine's streams in traffic
    against the same requests sent alone; (b) the engine serving
    concurrent requests at Llama-2-7B size; (c) the engine's byte-exact
    contracts on the tiny config in f32, requests decoding together.
    Returns (b)'s TTFT, ITL and generated tokens/s, which the runtime
    phase prints beside its own."""
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
        steps = engine_steps()
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
    timing = stream_timing([r[4] for r in results])
    n_tokens = sum(len(r[2]) for r in results)
    step_ms = step_breakdown(steps)

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
          "ttft_s": quantiles(ttft), **timing,
          "generated_tokens": n_tokens, "generated_tokens_per_s": n_tokens / wall_s,
          "steps": engine_stats["total_steps"], "step_ms": step_ms,
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
    return {"clients": SERVE_CLIENTS, "requests": SERVE_REQUESTS, "ttft_s": quantiles(ttft),
            **timing, "generated_tokens_per_s": n_tokens / wall_s, "step_ms": step_ms}


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


# ---------------------------------------------------------------------------
# 8. runtime: the port's own cluster places work on the GPU


#: the runtime's traffic at full size: RT_CLIENTS threads send RT_REQUESTS
#: requests in all to one num_gpus=1 actor
RT_CLIENTS, RT_REQUESTS, RT_NEW_TOKENS = 4, 16, 32


def rt_wait_leases_returned(rt, timeout=30.0):
    """Until every lease is back with the daemon (an owner keeps an idle
    lease for ``lease_linger_s``): the next lease then pops the newest
    pooled worker, so the one that ran the last CPU task is reused."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        total, avail = rt.cluster_resources(), rt.available_resources()
        if all(avail.get(k, 0) == v for k, v in total.items()):
            return
        time.sleep(0.05)
    raise RuntimeError(f"chip_smoke check failed: leases still held: {rt.available_resources()}")


def rt_pid_gone(pid, timeout=15.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split()[2] == "Z":
                    return True
        except OSError:
            return True
        time.sleep(0.05)
    return False


def rt_device_view(init_cuda=False, touch=False):
    """A task's view of the card: its pid, ``CUDA_VISIBLE_DEVICES``,
    torch's device count (by NVML, which initialises nothing). With
    ``init_cuda`` its torch first tries to initialise CUDA (under the
    daemon's pin that fails, and torch keeps a count of none); with
    ``touch`` it runs one CUDA op and names the device."""
    import os

    import torch

    out = {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "device_count": torch.cuda.device_count()}
    if init_cuda:
        try:
            torch.cuda.init()
            out["init_error"] = None
        except RuntimeError as e:
            out["init_error"] = str(e)
    if touch:
        out["sum"] = float(torch.ones(4, device="cuda").sum())
        out["device"] = torch.cuda.get_device_name(0)
    return out


def rt_kernels_in_worker(case, seed):
    """The three kernels at ``case``'s shapes inside a runtime worker, each
    held against its plain version by ``kernel_check.compare`` (the
    backward kernels on the plain forward's lse, as ``parity_case``);
    returns the report and ``o`` itself, a bf16 CUDA tensor."""
    import hashlib
    import os

    import torch
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.tools import kernel_check as K

    t0 = time.perf_counter()
    _path, build = _build.build()
    c = case
    q, k, v, do = K.make_inputs(c["b"], c["h"], c["hk"], c["s"], c["d"], c["dtype"], seed)
    h, hk, causal, sc = c["h"], c["hk"], c["causal"], 1.0 / math.sqrt(c["d"])
    kw = dict(causal=causal, sm_scale=sc, h=h, hk=hk)
    A.reset_launch_counts()
    o, _lse = A.flash_fwd(q, k, v, **kw)
    po, plse = A._fwd_plain(q, k, v, causal, sc, h, hk)
    delta = (do.float() * po.float()).sum(dim=-1, keepdim=True)
    dq = A.flash_bwd_dq(q, k, v, do, plse, delta, **kw)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, plse, delta, **kw)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in A.KERNELS}
    routes = {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS}
    pdk, pdv = A._bwd_dkv_plain(q, k, v, do, plse, delta, causal, sc, h, hk)
    readings = {"o": K.compare(o, po, c["dtype"]),
                "dq": K.compare(dq, A._bwd_dq_plain(q, k, v, do, plse, delta, causal, sc, h, hk),
                                c["dtype"], "grad"),
                "dk": K.compare(dk, pdk, c["dtype"], "grad"),
                "dv": K.compare(dv, pdv, c["dtype"], "grad")}
    report = {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
              "device_count": torch.cuda.device_count(), "device": torch.cuda.get_device_name(0),
              "build_cached": build["cached"], "launches": launches, "launches_by_route": routes,
              "readings": readings, "seconds": time.perf_counter() - t0, "o_shape": list(o.shape),
              "o_sha256": hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()}
    return report, o


class RtGpuHolder:
    """A ``num_gpus=1`` actor that only holds its GPU."""

    def ping(self):
        import os

        return os.getpid()


class RtLLMActor:
    """A ``num_gpus=1`` actor around the port's ``LLMServer`` built from
    ``LlamaConfig.llama2_7b(**overrides)`` (``dtype`` named by string):
    ``generate`` is a streaming actor method, and the actor reads its own
    init time and peak memory. TF32 is off, so f32 is full f32."""

    def __init__(self, overrides, engine, seed):
        import torch
        from ray_tpu_torch.inference import EngineConfig, LLMServer
        from ray_tpu_torch.models import llama as L

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        cfg = L.LlamaConfig.llama2_7b(**{**overrides, "dtype": getattr(torch, overrides["dtype"])})
        self.server = LLMServer(cfg, EngineConfig(**engine), seed=seed)
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0

    def info(self):
        import os

        import torch

        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0), "init_s": self.init_s,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}

    def generate(self, request):
        yield from self.server.generate(request)

    def engine_stats(self):
        return self.server.engine_stats()

    def engine_steps(self, clear=False):
        """The engine's steps since the last clear, read in the actor."""
        from ray_tpu_torch.observability import timeline

        steps = engine_steps()
        if clear:
            timeline.clear_events()
        return steps


def rt_stream(actor, request):
    """One request streamed from the actor: its tokens and each token's
    arrival time (a burst's tokens arrive together)."""
    import ray_tpu_torch as rt

    toks, times = [], []
    for ref in actor.generate.options(num_returns="streaming").remote(request):
        chunk = rt.get(ref, timeout=300)
        now = time.perf_counter()
        toks += list(chunk)
        times += [now] * len(chunk)
    return toks, times


def rt_witness_requests(vocab):
    import numpy as np

    rs = np.random.RandomState(31)
    return [dict(prompt=[int(x) for x in rs.randint(1, vocab, size=n)], max_new_tokens=16,
                 request_id=f"w{i}", **({} if i % 2 == 0 else dict(temperature=0.8, seed=900 + i)))
            for i, n in enumerate((40, 100, 190, 48))]


def rt_traffic(actor, vocab, seed):
    """RT_REQUESTS requests from RT_CLIENTS threads, prompts of 64-1024
    tokens drawn from ``seed``, RT_NEW_TOKENS new tokens, even ones greedy
    and odd ones seeded at temperature 0.8."""
    import threading

    import numpy as np

    rs = np.random.RandomState(seed)
    reqs = [dict(prompt=[int(x) for x in rs.randint(1, vocab, size=rs.randint(64, 1025))],
                 max_new_tokens=RT_NEW_TOKENS, request_id=f"rt{i}",
                 **({} if i % 2 == 0 else dict(temperature=0.8, seed=3000 + i)))
            for i in range(RT_REQUESTS)]
    results, errors = [None] * RT_REQUESTS, []

    def client(c):
        try:
            for i in range(c, RT_REQUESTS, RT_CLIENTS):
                t0 = time.perf_counter()
                toks, times = rt_stream(actor, reqs[i])
                results[i] = (len(reqs[i]["prompt"]), toks, t0, times)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(RT_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "runtime traffic threads finished")
    if errors:
        raise errors[0]
    return results, wall_s


def phase_runtime(torch, K, L, smi: str, serve_summary: dict):
    """The port's runtime on the card: (a) the daemon detects the GPU and
    hides it from CPU tasks; (b) a num_gpus=1 task on the pooled worker
    that ran (a)'s CPU task runs the three kernels, and its bf16 ``o``
    comes back through the object store as a CPU tensor with the same bits;
    a worker whose torch read the devices under the pin is refused a GPU
    lease and retired; (c) a num_gpus=1 actor keeps a second num_gpus=1
    task pending until it is killed; (d) a num_gpus=1 actor serving through
    ``LLMServer``: f32 streams equal the in-process server's, then full
    Llama-2-7B in bf16 answering 16 requests from 4 threads; (e) no
    process of the cluster survives shutdown."""
    import gc
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' engines and caches are gone
    t_phase = time.perf_counter()
    device_view = rt.remote(rt_device_view)
    try:
        # (a) detection: no resources given, the daemon finds the card
        rt.init(num_cpus=4)
        total = rt.cluster_resources()
        cpu = rt.get(device_view.remote(), timeout=120)
        emit({"phase": "runtime", "part": "a_detection", "cluster_resources": total,
              "cpu_task": cpu, "nvidia_smi": smi})
        check(total.get("GPU") == 1, f"the daemon detected one GPU: {total}")
        check(cpu["cuda_visible_devices"] == "" and cpu["device_count"] == 0,
              f"a CPU task sees no GPU: {cpu}")

        # (b) the kernels in a GPU worker: the pooled worker of (a), promoted
        rt_wait_leases_returned(rt)
        task = rt.remote(num_gpus=1)(rt_kernels_in_worker)
        report, o = rt.get(task.remote(K.MAIN, 0), timeout=300)
        got_sha = hashlib.sha256(o.view(torch.int16).numpy().tobytes()).hexdigest()
        part_b = {"phase": "runtime", "part": "b_kernels_in_gpu_worker", "case": K.MAIN, **report,
                  "promoted_pooled_worker": report["pid"] == cpu["pid"],
                  "o_received": {"type": type(o).__name__, "device": str(o.device),
                                 "dtype": str(o.dtype), "shape": list(o.shape),
                                 "sha256_equal": got_sha == report["o_sha256"]}}
        emit(part_b)
        check(part_b["promoted_pooled_worker"], "the GPU task ran on (a)'s pooled worker")
        check(report["cuda_visible_devices"] == "0" and report["device_count"] == 1,
              f"the GPU task sees GPU 0 alone: {report['cuda_visible_devices']!r}")
        check(report["device"] == torch.cuda.get_device_name(0), "the task's device is the card")
        check(report["build_cached"], "the worker found the driver's kernel build cached")
        for name, routes in report["launches_by_route"].items():
            check(routes == {"tensor_core": 1, "cuda_core": 0},
                  f"{name} launched once on the tensor cores in the worker: {routes}")
        for what, r in report["readings"].items():
            check(r["ok"], f"worker {what}: {r}")
        check(isinstance(o, torch.Tensor) and o.device.type == "cpu" and o.dtype == torch.bfloat16
              and list(o.shape) == report["o_shape"],
              f"o comes back a CPU bf16 tensor: {part_b['o_received']}")
        check(got_sha == report["o_sha256"], "o's bits survive the object store")
        del o

        # (b) the trouble spot: torch that read the devices under the pin
        rt_wait_leases_returned(rt)
        poisoned = rt.get(device_view.remote(init_cuda=True), timeout=120)
        rt_wait_leases_returned(rt)
        fresh = rt.get(device_view.options(num_gpus=1).remote(touch=True), timeout=120)
        part_b2 = {"phase": "runtime", "part": "b_refused_promotion", "poisoned": poisoned,
                   "gpu_task": fresh, "poisoned_retired": rt_pid_gone(poisoned["pid"])}
        emit(part_b2)
        check(poisoned["init_error"] is not None, f"CUDA init fails under the pin: {poisoned}")
        check(fresh["pid"] != poisoned["pid"] and part_b2["poisoned_retired"],
              "the worker whose torch read no devices was refused the lease and retired")
        check(fresh["cuda_visible_devices"] == "0" and fresh["sum"] == 4.0,
              f"the GPU task ran on a fresh worker that can use the GPU: {fresh}")

        # (c) GPU accounting
        rt_wait_leases_returned(rt)
        h = rt.remote(num_gpus=1)(RtGpuHolder).remote()
        held_pid = rt.get(h.ping.remote(), timeout=120)
        pending = device_view.options(num_gpus=1).remote()
        ready, _ = rt.wait([pending], timeout=2)
        pending_while_held = not ready
        rt.kill(h)
        after_kill = rt.get(pending, timeout=120)
        rt_wait_leases_returned(rt)
        avail = rt.available_resources()
        part_c = {"phase": "runtime", "part": "c_gpu_accounting", "holder_pid": held_pid,
                  "pending_while_held": pending_while_held, "after_kill": after_kill,
                  "available_after": avail}
        emit(part_c)
        check(pending_while_held, "a second num_gpus=1 task waits while the GPU actor lives")
        check(after_kill["cuda_visible_devices"] == "0", "it runs once the actor is killed")
        check(avail.get("GPU") == 1, f"the GPU is free again after every lease: {avail}")

        # (d) serving through the runtime. f32 witness first: 2 layers,
        # TF32 off, the same seed as an in-process server in this process
        from ray_tpu_torch.inference import EngineConfig, LLMServer

        t0 = time.perf_counter()
        llm = rt.remote(num_gpus=1, max_concurrency=8)(RtLLMActor)
        actor = llm.remote({"n_layers": 2, "dtype": "float32"}, LLM_F32_ENGINE, 1)
        info32 = rt.get(actor.info.remote(), timeout=300)
        cfg32 = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
        reqs = rt_witness_requests(cfg32.vocab_size)
        through_rt = [rt_stream(actor, r)[0] for r in reqs]
        local = LLMServer(cfg32, EngineConfig(**LLM_F32_ENGINE), seed=1)
        try:
            in_process = [flat(local.generate(r)) for r in reqs]
        finally:
            local.engine.stop()
        del local
        gc.collect()
        torch.cuda.empty_cache()
        rt.kill(actor)
        part_d32 = {"phase": "runtime", "part": "d_f32_witness",
                    "config": "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)",
                    "reduced": ["n_layers 32 -> 2"], "tf32": False, "actor": info32,
                    "requests": [{"prompt_len": len(r["prompt"]),
                                  "temperature": r.get("temperature", 0.0)} for r in reqs],
                    "streams_equal": [a == b for a, b in zip(through_rt, in_process)],
                    "lengths": [len(a) for a in through_rt], "seconds": time.perf_counter() - t0}
        emit(part_d32)
        check(info32["cuda_visible_devices"] == "0", "the f32 actor holds GPU 0")
        check(all(part_d32["streams_equal"]) and part_d32["lengths"] == [16] * 4,
              "f32 streams through the runtime equal the in-process server's byte for byte")

        # full size: Llama-2-7B in bf16 with the serve phase's engine
        rt_wait_leases_returned(rt)
        cfg = L.LlamaConfig.llama2_7b()
        actor = llm.remote({"dtype": "bfloat16"}, SERVE_ENGINE, 0)
        info = rt.get(actor.info.remote(), timeout=600)
        rt.get(actor.engine_steps.remote(clear=True), timeout=60)  # warmup's steps go
        results, wall_s = rt_traffic(actor, cfg.vocab_size, seed=33)
        steps = rt.get(actor.engine_steps.remote(), timeout=60)
        stats = rt.get(actor.engine_stats.remote(), timeout=60)
        info_after = rt.get(actor.info.remote(), timeout=60)
        rt.kill(actor)
        ttft = [r[3][0] - r[2] for r in results]
        n_tokens = sum(len(r[1]) for r in results)
        part_d = {"phase": "runtime", "part": "d_serve_7b", "config": "LlamaConfig.llama2_7b()",
                  "params": L.param_count(cfg), "reduced": [], "engine": SERVE_ENGINE,
                  "clients": RT_CLIENTS, "requests": RT_REQUESTS, "new_tokens": RT_NEW_TOKENS,
                  "prompt_lens": [r[0] for r in results],
                  "answered": sum(len(r[1]) == RT_NEW_TOKENS for r in results),
                  "actor_init_s": info["init_s"],
                  "actor_max_memory_allocated_bytes": info_after["max_memory_allocated_bytes"],
                  "wall_s": wall_s, "ttft_s": quantiles(ttft),
                  **stream_timing([r[3] for r in results]),
                  "generated_tokens": n_tokens, "generated_tokens_per_s": n_tokens / wall_s,
                  "step_ms": step_breakdown(steps),
                  "blocks": stats["blocks"], "recompiles_after_warmup":
                      stats["recompiles_after_warmup"],
                  "in_process_serve_phase": serve_summary, "nvidia_smi": smi}
        emit(part_d)
        check(part_d["answered"] == RT_REQUESTS,
              f"every request finished with {RT_NEW_TOKENS} tokens: {part_d['answered']}")
        check(stats["blocks"]["used_blocks"] == 0 and stats["blocks"]["holders"] == 0,
              f"the actor's engine got every block back: {stats['blocks']}")
        check(stats["recompiles_after_warmup"] == 0, "no new shape after warmup in the actor")

        # (e) shutdown, with a pooled worker alive beside the head
        rt.get(device_view.remote(), timeout=120)
        pids = find_runtime_pids(spawner_pid=os.getpid())
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "runtime", "part": "e_shutdown", "processes_before": len(pids),
          "left_after": left, "seconds": time.perf_counter() - t_phase})
    check(len(pids) >= 2 and not left,
          f"no process of the cluster ({len(pids)} before) survives shutdown: {left}")


# ---------------------------------------------------------------------------
# 9. serve_deployment: llm_deployment behind the serve router on the cluster


#: (c): the deployment's concurrency, room for the serve traffic's 8 clients
SD_MAX_QUERIES = 16
#: (d): the streams live when the drain starts
SD_DRAIN_STREAMS = 4


class HandleClient:
    """``serve_traffic``'s engine interface over a deployment handle: each
    ``generate`` streams one request through the serve router."""

    def __init__(self, handle):
        self.handle = handle

    def generate(self, prompt, request_id, **kw):
        yield from self.handle.stream({"prompt": prompt, "request_id": request_id, **kw},
                                      _method="generate", _timeout=600)


def sd_stream(handle, request):
    """One request through the handle: its tokens and their arrival times."""
    toks, times = [], []
    for tok in handle.stream(request, _method="generate", _timeout=600):
        toks.append(tok)
        times.append(time.perf_counter())
    return toks, times


def actor_env(handle, var="CUDA_VISIBLE_DEVICES"):
    """An actor's pid and ``var`` in the environment its process was
    spawned with (None when unset)."""
    from ray_tpu_torch.util import state

    aid = handle._actor_id.hex()
    pid = next(a["pid"] for a in state.list_actors() if a["actor_id"] == aid)
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
    val = env.get(var.encode())
    return pid, None if val is None else val.decode()


def wait_gpu_back(rt, timeout_s: float = 60.0):
    """Waits until the cluster's one GPU is free again (a deleted
    deployment's replica gives its lease back as its process exits)."""
    deadline = time.monotonic() + timeout_s
    while rt.available_resources().get("GPU", 0) != 1:
        check(time.monotonic() < deadline, f"the GPU is back: {rt.available_resources()}")
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the ingress phase: the HTTP/SSE door (serve/ingress.py) in front of the
# deployments of phase serve_deployment, and the seeded trace harness
# (serve/loadgen.py) through it


#: (a): the door's tenants (``tests/test_ingress.py``'s), the disconnected
#: stream's length and the abuser's requests (cost 4 + 8 = 12 each)
INGRESS_F32_TENANTS = dict(abuser=dict(rate=2.0, burst=50.0, tenant_class="batch"),
                           vip=dict(tenant_class="interactive"))
INGRESS_CUT_TOKENS, INGRESS_F32_ABUSES = 48, 12
#: (b): the trace replayed at 7B (prompts of at most 512 tokens with their
#: prefix, so 8 slots of 576 tokens hold 288 of the 640 blocks), the
#: abusive tenant beside it, and the SLOs the run is scored against
INGRESS_SPEC = dict(seed=20260806, duration_s=20.0, base_rate_rps=2.0,
                    burst_period_s=10.0, burst_duty=0.2, burst_factor=3.0,
                    n_tenants=8, prompt_min=16, prompt_max=512,
                    output_min=8, output_max=64, n_prefixes=4, prefix_len=128,
                    prefix_reuse=0.7, vocab=32000)
INGRESS_ABUSER = dict(rate=100.0, burst=400.0, tenant_class="batch")
INGRESS_ABUSES, INGRESS_ABUSE_RPS, INGRESS_ABUSE_PROMPT, INGRESS_ABUSE_NEW = 40, 10.0, 64, 16
INGRESS_TTFT_SLO_S, INGRESS_ITL_SLO_S = 2.0, 0.5


def flash_launches(A) -> dict:
    """This process's launches of each flash kernel."""
    return {fn.__name__: fn.launches for fn in A.KERNELS}


def process_maps(pid) -> str:
    """The memory map of process ``pid`` ("" once it is gone)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return f.read()
    except OSError:
        return ""


def door_process(handle) -> dict:
    """A door replica's pid, the ``CUDA_VISIBLE_DEVICES`` it was spawned
    with, and whether its process has the CUDA driver or torch mapped now
    (a process that never mapped ``libcuda.so`` launched no kernel: read
    it after the door's traffic)."""
    pid, env = actor_env(handle)
    maps = process_maps(pid)
    return {"pid": pid, "cuda_visible_devices": env,
            "libcuda_mapped": "libcuda.so" in maps, "torch_loaded": "libtorch" in maps}


def ingress_door(rt, serve, target: str, name: str, tenants: dict) -> dict:
    """``ingress_deployment(target, ...)`` as a CPU deployment: its
    addresses, its replicas and their processes as deployed."""
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.serve.ingress import (IngressConfig, TenantPolicy, ingress_addresses,
                                             ingress_deployment)

    t0 = time.perf_counter()
    ing_cfg = IngressConfig(tenants={t: TenantPolicy(**p) for t, p in tenants.items()})
    serve.run(ingress_deployment(target, ing_cfg, name=name,
                                 ray_actor_options={"num_cpus": 0.1}).bind(), name=name)
    addresses = ingress_addresses(name)
    replicas = rt.get(get_or_create_controller().get_replicas.remote(name), timeout=60)
    return {"name": name, "addresses": addresses, "replicas": replicas,
            "processes": [door_process(r) for r in replicas],
            "deploy_s": time.perf_counter() - t0}


def check_doors(door, what: str) -> None:
    check(door["processes"] and all(
        p["cuda_visible_devices"] == "" and not p["libcuda_mapped"] for p in door["processes"]),
        f"{what}: every door replica sees CUDA_VISIBLE_DEVICES=\"\" and never loaded CUDA: "
        f"{door['processes']}")


def balanced_books(serve, deployments, timeout_s: float = 30.0):
    """``serve.slo_report()`` once the ingress and engine books of
    ``deployments`` exist and balance (the identities hold at quiesce)."""
    deadline = time.monotonic() + timeout_s
    while True:
        rep = serve.slo_report()
        books = [b for n in deployments
                 for b in rep["deployments"].get(n, {}).get("books", ())]
        kinds = {b.get("kind") for b in books}
        if {"ingress", "engine"} <= kinds and all(b["balanced"] for b in books):
            return rep, books
        check(time.monotonic() < deadline, f"the ingress and engine books balance: {books}")
        time.sleep(0.5)


def engine_quiet(rt, handle, timeout_s: float = 30.0):
    """Polls the engine until nothing runs or queues and every block is
    back; returns its stats and the seconds it took."""
    t0 = time.monotonic()
    while True:
        s = rt.get(handle.method("engine_stats")(), timeout=60)
        if (s["scheduler"]["running"] == 0 and s["scheduler"]["queue_depth"] == 0
                and s["blocks"]["used_blocks"] == 0):
            return s, time.monotonic() - t0
        if time.monotonic() - t0 > timeout_s:
            return s, None
        time.sleep(0.05)


def ingress_f32(rt, serve, handle, target: str, reqs, expected, smi: str) -> None:
    """(a) The door in front of the tiny f32 deployment bound ``params=``:
    its SSE streams equal the in-process server's byte for byte; a stream
    closed after 2 tokens cancels its engine request (admitted once,
    blocks back); the abuser's sheds were never admitted; a malformed body
    gets 400; the books balance."""
    import urllib.error
    import urllib.request

    from ray_tpu_torch.serve.ingress import IngressShedError, http_stream

    t0 = time.perf_counter()
    door = ingress_door(rt, serve, target, f"{target}-door", INGRESS_F32_TENANTS)
    addr = door["addresses"][0]

    def estats():
        return rt.get(handle.method("engine_stats")(), timeout=60)

    over_http = [list(http_stream(addr, r, tenant="vip")) for r in reqs]

    # a disconnect mid-stream reaches engine.cancel()
    base = estats()["scheduler"]["total_admitted"]
    cancelled0 = rt.get(handle.method("slo_snapshot")(), timeout=60)["books"].get("cancelled", 0)
    gen = http_stream(addr, {"prompt": [3, 7, 11], "max_new_tokens": INGRESS_CUT_TOKENS},
                      tenant="vip")
    before_close = len([next(gen), next(gen)])
    gen.close()  # the HTTP connection drops here
    after_cut, close_to_quiet_s = engine_quiet(rt, handle)
    cancelled = (rt.get(handle.method("slo_snapshot")(), timeout=60)["books"].get("cancelled", 0)
                 - cancelled0)

    # the abuser's bucket: every 200 one admission, every 429 none
    base_shed = estats()["scheduler"]["total_admitted"]
    ok, retry_afters, reasons = 0, [], []
    for _ in range(INGRESS_F32_ABUSES):
        try:
            out = list(http_stream(addr, {"prompt": [9, 2, 4, 6], "max_new_tokens": 8},
                                   tenant="abuser"))
            check(len(out) == 8, f"an admitted abuser request got 8 tokens: {out}")
            ok += 1
        except IngressShedError as e:
            reasons.append(e.reason)
            retry_afters.append(e.retry_after)
    shed = len(reasons)
    admitted = estats()["scheduler"]["total_admitted"] - base_shed
    deadline = time.monotonic() + 15
    while True:
        st = serve.status()
        if st[door["name"]].get("shed_total", 0) >= shed or time.monotonic() > deadline:
            break
        time.sleep(0.25)

    # a malformed body stops at the door
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"http://{addr}/generate", data=b'{"nope": 1}',
            headers={"Content-Type": "application/json"}), timeout=30)
        bad_status = 200
    except urllib.error.HTTPError as e:
        bad_status = e.code

    rep, books = balanced_books(serve, (target,))
    ib = next(b for b in books if b.get("kind") == "ingress")
    # the doors' processes again, after every request of this part
    door["processes"] = [door_process(r) for r in door["replicas"]]
    part = {"phase": "ingress", "part": "a_f32_door", "target": target, "door": door["name"],
            "door_processes": door["processes"], "door_deploy_s": door["deploy_s"],
            "streams_equal": [a == b for a, b in zip(over_http, expected)],
            "lengths": [len(a) for a in over_http],
            "disconnect": {"tokens_before_close": before_close,
                           "close_to_blocks_back_s": close_to_quiet_s,
                           "admitted": after_cut["scheduler"]["total_admitted"] - base,
                           "cancelled": cancelled, "running": after_cut["scheduler"]["running"],
                           "used_blocks": after_cut["blocks"]["used_blocks"]},
            "abuser": {"sent": INGRESS_F32_ABUSES, "ok": ok, "shed": shed,
                       "reasons": sorted(set(reasons)), "retry_after_s": retry_afters,
                       "admitted": admitted,
                       "status_shed_total": st[door["name"]].get("shed_total")},
            "malformed_status": bad_status, "ingress_books": ib,
            "engine_books": [b for b in books if b.get("kind") == "engine"],
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part)
    check_doors(door, "(a)")
    check(all(part["streams_equal"]) and len(over_http) == len(expected),
          "the door's SSE streams equal the in-process server's byte for byte")
    d = part["disconnect"]
    check(close_to_quiet_s is not None and d["running"] == 0 and d["used_blocks"] == 0,
          f"a closed stream brings the engine back to nothing running, every block back: {d}")
    check(d["admitted"] == 1, f"the disconnected request was admitted once: {d}")
    check(ok >= 1 and shed >= 1, f"the abuser got some requests through and was shed: {ok}, {shed}")
    check(set(reasons) == {"rate_limit"} and all(r > 0 for r in retry_afters),
          f"every shed is rate_limit with Retry-After > 0: {reasons}, {retry_afters}")
    check(admitted == ok, f"shed means never admitted: {admitted} admitted for {ok} served")
    check(part["abuser"]["status_shed_total"] == shed,
          f"serve.status() counts the sheds: {st[door['name']]}")
    check(bad_status == 400, f"a malformed body gets 400: {bad_status}")
    check(ib["shed"] == shed and ib["bad_request"] == 1
          and ib["seen"] == ib["shed"] + ib["bad_request"] + ib["forwarded"],
          f"the ingress books: {ib}")
    serve.delete(door["name"])


def ingress_7b(rt, serve, handle, target: str, smi: str) -> None:
    """(b) The door in front of the full Llama-2-7B replica: the seeded
    trace through ``loadgen.run_trace`` with an abusive tenant beside it.
    Every request comes back ok or shed (with a reason and a Retry-After),
    the abuser is shed, the door's counts reconcile with the engine's
    admissions, the books balance; it prints the TTFT split between the
    client, the door and the engine."""
    import dataclasses
    import threading

    import numpy as np

    from ray_tpu_torch.serve import loadgen
    from ray_tpu_torch.serve.ingress import IngressShedError, http_stream, pick_ingress

    t0 = time.perf_counter()
    spec = loadgen.LoadSpec(**INGRESS_SPEC)
    trace = loadgen.build_trace(spec)
    # the trace's tenants on the default buckets, in the trace's classes
    tenants = {r.tenant: {"tenant_class": r.tenant_class} for r in trace}
    door = ingress_door(rt, serve, target, f"{target}-door",
                        {**tenants, "abuser": INGRESS_ABUSER})
    addrs = door["addresses"]
    admitted0 = rt.get(handle.method("engine_stats")(), timeout=60)["scheduler"]["total_admitted"]

    rs = np.random.default_rng(spec.seed)
    abuse_prompt = [int(x) for x in rs.integers(1, spec.vocab, INGRESS_ABUSE_PROMPT)]
    abuser = {"ok": 0, "shed": [], "errors": [], "ttft_s": []}
    lock = threading.Lock()

    def abuse_one(addr):
        try:
            t_sent, first, n = time.monotonic(), None, 0
            for _ in http_stream(addr, {"prompt": abuse_prompt,
                                        "max_new_tokens": INGRESS_ABUSE_NEW},
                                 tenant="abuser", timeout_s=30.0):
                if first is None:
                    first = time.monotonic() - t_sent
                n += 1
            with lock:
                abuser["ok"] += 1
                abuser["ttft_s"].append(first)
                if n != INGRESS_ABUSE_NEW:
                    abuser["errors"].append(f"{n} tokens")
        except IngressShedError as e:
            with lock:
                abuser["shed"].append((e.reason, e.retry_after))
        except Exception as e:  # noqa: BLE001 — counted and checked below
            with lock:
                abuser["errors"].append(repr(e))

    def abuse():
        """INGRESS_ABUSES requests at INGRESS_ABUSE_RPS, each on its own
        thread, so an admitted one does not hold back the next."""
        addr = pick_ingress("abuser", addrs)
        start, sent = time.monotonic(), []
        for i in range(INGRESS_ABUSES):
            delay = start + i / INGRESS_ABUSE_RPS - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            sent.append(threading.Thread(target=abuse_one, args=(addr,)))
            sent[-1].start()
        for t in sent:
            t.join(timeout=120)

    t_run = time.perf_counter()
    thread = threading.Thread(target=abuse)
    thread.start()
    run = loadgen.run_trace(trace, spec=spec, addresses=addrs, time_scale=1.0,
                            status_fn=serve.status)
    thread.join(timeout=300)
    wall_s = time.perf_counter() - t_run
    check(not thread.is_alive(), "the abuser's thread finished")
    engine_window = rt.get(handle.method("routing_stats")(), timeout=60)
    stats, _ = engine_quiet(rt, handle, timeout_s=60)
    dbg = [rt.get(r.handle_request.remote("debug_stats", [], {}, ""), timeout=60)
           for r in door["replicas"]]
    rep, books = balanced_books(serve, (target,))
    # the doors' processes again, after every request of this part
    door["processes"] = [door_process(r) for r in door["replicas"]]
    score = loadgen.score(run, ttft_slo_s=INGRESS_TTFT_SLO_S, itl_slo_s=INGRESS_ITL_SLO_S,
                          report=rep, status=serve.status())

    recs = run.records
    outcomes = {o: sum(r["outcome"] == o for r in recs) for o in ("ok", "shed", "error")}
    sheds = [r for r in recs if r["outcome"] == "shed"]
    sent = len(trace) + INGRESS_ABUSES
    door_ok = sum(n for d in dbg for k, n in d["outcomes"].items() if k.endswith(":ok"))
    door_shed = sum(d["shed_total"] for d in dbg)
    forwarded = sum(d["forwarded_total"] for d in dbg)
    admitted = stats["scheduler"]["total_admitted"] - admitted0
    ttfts = sorted(r["ttft_s"] for r in recs if r["outcome"] == "ok")
    door_ttfbs = sorted(v for d in dbg for v in d["ttfb_samples_s"])
    tokens = sum(r.get("n_tokens", 0) for r in recs if r["outcome"] == "ok")
    shed_by = {}
    for r in sheds:
        key = f"{r['tenant_class']}:{r['shed_reason']}"
        shed_by[key] = shed_by.get(key, 0) + 1
    for reason, _ in abuser["shed"]:
        key = f"batch(abuser):{reason}"
        shed_by[key] = shed_by.get(key, 0) + 1
    part = {"phase": "ingress", "part": "b_7b_trace", "target": target, "door": door["name"],
            "door_processes": door["processes"], "door_deploy_s": door["deploy_s"],
            "spec": dataclasses.asdict(spec),
            "trace_requests": len(trace),
            "trace_prompt_tokens": [min(len(r.prompt) for r in trace),
                                    max(len(r.prompt) for r in trace)],
            "abuser": {"tenant": INGRESS_ABUSER, "sent": INGRESS_ABUSES, "ok": abuser["ok"],
                       "shed": len(abuser["shed"]), "errors": abuser["errors"],
                       "retry_after_s_min": min((r for _, r in abuser["shed"]), default=None)},
            "outcomes": outcomes, "shed_by_class_reason": shed_by,
            "errors": [r.get("error") for r in recs if r["outcome"] == "error"][:5],
            "counts": {"sent": sent, "ok": door_ok, "shed": door_shed, "forwarded": forwarded,
                       "sheds": [d["sheds"] for d in dbg], "engine_admitted": admitted},
            # the client's clock (the trace's requests, then every
            # forwarded one: the trace's and the abuser's admitted, the
            # population of the next two); the door's (arrival to first SSE
            # byte, one sample per forwarded request); the door's
            # router (dispatch to first token, by class: what
            # serve.slo_report() reports for the deployment); the engine's
            # (submit to first token): its last 30 s, and since its start
            # with phase serve_deployment (c)'s traffic in it
            "ttft_s": {"client": quantiles(ttfts),
                       "client_forwarded": quantiles(ttfts + abuser["ttft_s"]),
                       "door_ttfb": quantiles(door_ttfbs),
                       "router_by_class": {
                           cls: blk.get("ttft_s") for cls, blk in
                           rep["deployments"].get(target, {}).get("by_class", {}).items()
                           if cls},
                       "engine_p99_last_30s": engine_window["ttft_p99_s"],
                       "engine_since_start": stats["ttft"]},
            "itl_s": score["itl"], "generated_tokens": tokens,
            "generated_tokens_per_s": tokens / run.duration_s, "run_s": run.duration_s,
            "wall_s": wall_s, "score": {k: score[k] for k in (
                "requests", "ok", "shed", "errors", "ttft_attainment", "itl_attainment",
                "by_class", "e2e_p99")},
            "repro": score["repro"], "engine_blocks": stats["blocks"],
            "ingress_books": [b for b in books if b.get("kind") == "ingress"],
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part)
    check_doors(door, "(b)")
    check(outcomes["error"] == 0 and len(recs) == len(trace),
          f"every trace request came back ok or shed: {outcomes} {part['errors']}")
    check(not abuser["errors"], f"the abuser's requests came back ok or shed: {abuser['errors']}")
    check(all(r.get("shed_reason") and r.get("retry_after_s", 0) > 0 for r in sheds)
          and all(reason and ra > 0 for reason, ra in abuser["shed"]),
          "every shed carries a reason and Retry-After > 0")
    check(len(abuser["shed"]) > 0, f"the abuser was shed: {part['abuser']}")
    check(door_ok + door_shed == sent and forwarded == sent - door_shed,
          f"the door's counts reconcile: {part['counts']}")
    check(door_ok == outcomes["ok"] + abuser["ok"] and door_shed == len(sheds) + len(
        abuser["shed"]), f"the door's counts are the clients': {part['counts']}")
    check(admitted == forwarded,
          f"the engine admitted what the door forwarded: {part['counts']}")
    check(len(door_ttfbs) == forwarded,  # the trace forwards fewer than 512
          f"the door timed the first byte of every forwarded request: "
          f"{len(door_ttfbs)} of {forwarded}")
    check(stats["blocks"]["used_blocks"] == 0, f"every block came back: {stats['blocks']}")
    serve.delete(door["name"])


def phase_serve_deployment(torch, A, L, smi: str, serve_summary: dict):
    """``llm_deployment`` on the port's cluster: (a) a num_gpus=1 replica
    in f32 at 2 layers streams what an in-process server streams; a
    replica with no GPU lease raises; (b) that replica SIGKILLed mid-decode,
    its stream resumed on the controller's replacement; (b') a tiny
    replica bound ``params=`` made here serves them on its card; (c) full
    Llama-2-7B in bf16 answering the serve phase's traffic through the
    handle, then one request over HTTP; (d) a drain with 4 live streams;
    (e) no process survives shutdown. Returns (b)'s gap from the kill to
    the first resumed token."""
    import gc
    import json
    import os
    import socket
    import threading
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.inference import EngineConfig, LLMServer
    from ray_tpu_torch.observability.rpc_metrics import STREAM_RESUMES
    from ray_tpu_torch.serve.controller import get_or_create_controller
    from ray_tpu_torch.serve.replica import Replica
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' engines and caches are gone
    t_phase = time.perf_counter()
    A.reset_launch_counts()  # the deployment path's run starts here
    try:
        rt.init(num_cpus=4)
        total = rt.cluster_resources()
        check(total.get("GPU") == 1, f"the daemon detected one GPU: {total}")
        ctrl = get_or_create_controller()
        # a replica with no GPU lease builds on cuda, sees no device, raises
        nogpu = Replica.options(num_cpus=0.25).remote(
            LLMServer, [L.LlamaConfig.tiny(), EngineConfig(warmup=False)], {"seed": 0}, "nogpu")

        # (a) f32 at 2 layers, TF32 off on both sides
        t0 = time.perf_counter()
        cfg32 = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
        dep = serve.llm_deployment(cfg32, engine=EngineConfig(**LLM_F32_ENGINE), name="llm32",
                                   route_prefix="/llm32", seed=1, max_concurrent_queries=8,
                                   ray_actor_options={"num_gpus": 1})
        handle = serve.run(dep.bind())
        ready32_s = time.perf_counter() - t0
        info32 = rt.get(handle.method("testing_device_info")(), timeout=60)
        ctrl_pid, ctrl_env = actor_env(ctrl)
        reqs = rt_witness_requests(cfg32.vocab_size)
        served = [sd_stream(handle, r)[0] for r in reqs]
        local = LLMServer(cfg32, EngineConfig(**LLM_F32_ENGINE), seed=1)
        try:
            in_process = [flat(local.generate(r)) for r in reqs]
        finally:
            local.engine.stop()
        del local
        gc.collect()
        torch.cuda.empty_cache()
        try:
            rt.get(nogpu.health.remote(), timeout=120)
            nogpu_error = None
        except Exception as e:  # noqa: BLE001 — the failure is what (a) checks
            nogpu_error = str(e)[-300:]
        part_a = {"phase": "serve_deployment", "part": "a_f32_witness",
                  "config": "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)",
                  "reduced": ["n_layers 32 -> 2"], "engine": LLM_F32_ENGINE,
                  "cluster_resources": total, "deploy_to_ready_s": ready32_s, "replica": info32,
                  "controller": {"pid": ctrl_pid, "cuda_visible_devices": ctrl_env},
                  "requests": [{"prompt_len": len(r["prompt"]),
                                "temperature": r.get("temperature", 0.0)} for r in reqs],
                  "streams_equal": [a == b for a, b in zip(served, in_process)],
                  "lengths": [len(a) for a in served], "no_gpu_replica_error": nogpu_error,
                  "seconds": time.perf_counter() - t0}
        emit(part_a)
        check(info32["cuda_visible_devices"] == "0" and info32["device"] == "cuda:0"
              and info32["device_name"] == torch.cuda.get_device_name(0),
              f"the replica holds GPU 0: {info32}")
        check(info32["float32_matmul_precision"] == "highest", "the replica's f32 is full f32")
        check(ctrl_env == "", f"the serve controller sees no GPU: {ctrl_env!r}")
        check(all(part_a["streams_equal"]) and part_a["lengths"] == [16] * 4,
              "f32 streams through the deployment equal the in-process server's byte for byte")
        check(nogpu_error is not None and "no CUDA device" in nogpu_error,
              f"a replica without a GPU lease raises on cuda: {nogpu_error}")

        # (b) the replica SIGKILLed mid-decode; the stream resumes on the
        # controller's replacement, which gets the GPU back
        t0 = time.perf_counter()
        resumes0 = STREAM_RESUMES._values.get(("llm32",), 0.0)
        rt.get(handle.method("testing_arm_replica_chaos")(CHAOS_SPEC, CHAOS_SEED), timeout=60)
        toks, times = sd_stream(handle, dict(reqs[1], request_id="killed"))
        gaps = [b - a for a, b in zip(times, times[1:])]
        cut = max(range(len(gaps)), key=gaps.__getitem__)
        status = rt.get(ctrl.wait_status.remote("llm32", min_replicas=1, timeout_s=300),
                        timeout=330)
        info_b = rt.get(handle.method("testing_device_info")(), timeout=60)
        part_b = {"phase": "serve_deployment", "part": "b_replica_killed", "spec": CHAOS_SPEC,
                  "seed": CHAOS_SEED, "request": 1, "tokens_before_kill": cut + 1,
                  "kill_to_first_resumed_token_s": gaps[cut],
                  "other_gaps_max_s": max(g for i, g in enumerate(gaps) if i != cut),
                  "stream_equals_undisturbed": toks == served[1], "length": len(toks),
                  "resumes": STREAM_RESUMES._values.get(("llm32",), 0.0) - resumes0,
                  "restarts": status["restarts"], "replicas": status["replicas"],
                  "killed_pid_gone": rt_pid_gone(info32["pid"]), "replacement": info_b,
                  "available_gpu_with_replacement": rt.available_resources().get("GPU", 0),
                  "seconds": time.perf_counter() - t0}
        emit(part_b)
        kill_gap_s = gaps[cut]
        check(part_b["stream_equals_undisturbed"] and len(toks) == 16,
              "the resumed stream equals the undisturbed one, no gap and no repeat")
        check(part_b["resumes"] >= 1, "the router resumed the stream")
        check(status["restarts"].get("death") == 1 and status["replicas"] == 1,
              f"the controller replaced the dead replica once: {status}")
        check(part_b["killed_pid_gone"] and info_b["pid"] != info32["pid"],
              "the replacement is a new process")
        check(info_b["cuda_visible_devices"] == "0" and info_b["device"] == "cuda:0"
              and part_b["available_gpu_with_replacement"] == 0,
              "the GPU went back to the pool and then to the replacement")
        flash_a = [info32["flash_launches"], info_b["flash_launches"]]
        serve.delete("llm32")
        wait_gpu_back(rt)

        # (b') params made here, bound to a num_gpus=1 replica: they reach
        # it as host tensors, and it serves them on its card
        t0 = time.perf_counter()
        tiny = L.LlamaConfig.tiny(dtype=torch.float32)
        tiny_params = L.init_params(tiny, 2, device="cuda")
        dep = serve.llm_deployment(tiny, engine=EngineConfig(warmup=False), name="llmbound",
                                   route_prefix="/llmbound", ray_actor_options={"num_gpus": 1})
        handle = serve.run(dep.bind(params=tiny_params))
        info_p = rt.get(handle.method("testing_device_info")(), timeout=60)
        bound_reqs = [{"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "max_new_tokens": 12},
                      {"prompt": [2, 7, 1, 8, 2, 8], "max_new_tokens": 12,
                       "temperature": 0.8, "seed": 7}]
        served_p = [sd_stream(handle, r)[0] for r in bound_reqs]
        local = LLMServer(tiny, EngineConfig(warmup=False), params=tiny_params,
                          export_metrics=False)
        try:
            in_process_p = [flat(local.generate(r)) for r in bound_reqs]
        finally:
            local.engine.stop()
        del local, tiny_params
        part_bp = {"phase": "serve_deployment", "part": "b2_bound_params",
                   "config": "LlamaConfig.tiny(dtype=float32)",
                   "bound": "params=init_params(cfg, 2, device='cuda')",
                   "replica": {k: info_p[k] for k in ("pid", "cuda_visible_devices", "device",
                                                      "init_s")},
                   "streams_equal": [a == b for a, b in zip(served_p, in_process_p)],
                   "lengths": [len(a) for a in served_p],
                   "seconds": time.perf_counter() - t0}
        emit(part_bp)
        check(info_p["cuda_visible_devices"] == "0" and info_p["device"] == "cuda:0",
              f"a replica bound params= serves them on its card: {info_p}")
        check(all(part_bp["streams_equal"]) and part_bp["lengths"] == [12, 12],
              "the bound replica streams what the in-process server streams on those params")
        flash_a.append(info_p["flash_launches"])

        # phase ingress (a): the door in front of this replica. The flash
        # kernels' counts from here to the end of ingress (b), in this
        # process and every replica, are the ingress path's
        ingress_here0 = flash_launches(A)
        ingress_bound0 = rt.get(handle.method("testing_device_info")(), timeout=60)
        ingress_f32(rt, serve, handle, "llmbound", bound_reqs, in_process_p, smi)
        ingress_bound1 = rt.get(handle.method("testing_device_info")(), timeout=60)
        flash_a.append(ingress_bound1["flash_launches"])
        serve.delete("llmbound")
        wait_gpu_back(rt)

        # (c) full Llama-2-7B in bf16: the serve phase's engine, seed and
        # traffic, through the handle
        t0 = time.perf_counter()
        cfg = L.LlamaConfig.llama2_7b()
        dep = serve.llm_deployment(cfg, engine=EngineConfig(**SERVE_ENGINE), name="llm7b",
                                   route_prefix="/llm7b", seed=0,
                                   max_concurrent_queries=SD_MAX_QUERIES,
                                   ray_actor_options={"num_gpus": 1})
        handle = serve.run(dep.bind())
        ready_s = time.perf_counter() - t0
        resumes0 = STREAM_RESUMES._values.get(("llm7b",), 0.0)
        t0 = time.perf_counter()
        results = serve_traffic(torch, HandleClient(handle), cfg, seed=13)
        wall_s = time.perf_counter() - t0
        stats = rt.get(handle.method("engine_stats")(), timeout=60)
        info = rt.get(handle.method("testing_device_info")(), timeout=60)
        restarts = rt.get(ctrl.status.remote(), timeout=60)["llm7b"]["restarts"]
        ttft = [r[4][0] - r[3] for r in results]
        n_tokens = sum(len(r[2]) for r in results)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        proxy = serve.start_http(ctrl, port=port)
        greedy = results[2]
        body = json.dumps({"prompt": greedy[0], "max_new_tokens": SERVE_NEW_TOKENS}).encode()
        t_http = time.perf_counter()
        http = urllib.request.Request(f"http://127.0.0.1:{proxy.port}/llm7b", data=body,
                                      headers={"Content-Type": "application/json"})
        over_http = json.loads(urllib.request.urlopen(http, timeout=300).read())["result"]
        http_s = time.perf_counter() - t_http
        part_c = {"phase": "serve_deployment", "part": "c_serve_7b",
                  "config": "LlamaConfig.llama2_7b()", "params": L.param_count(cfg),
                  "reduced": [], "engine": SERVE_ENGINE, "max_concurrent_queries": SD_MAX_QUERIES,
                  "clients": SERVE_CLIENTS, "requests": SERVE_REQUESTS,
                  "new_tokens": SERVE_NEW_TOKENS, "prompt_lens": [len(r[0]) for r in results],
                  "answered": sum(len(r[2]) == SERVE_NEW_TOKENS for r in results),
                  "resumes": STREAM_RESUMES._values.get(("llm7b",), 0.0) - resumes0,
                  "restarts": restarts, "deploy_to_ready_s": ready_s, "replica_init_s": info["init_s"],
                  "replica_max_memory_allocated_bytes": info["max_memory_allocated_bytes"],
                  "wall_s": wall_s, "ttft_s": quantiles(ttft),
                  **stream_timing([r[4] for r in results]),
                  "generated_tokens": n_tokens, "generated_tokens_per_s": n_tokens / wall_s,
                  "blocks": stats["blocks"], "prefix_cache": stats["prefix_cache"],
                  "compile_count": stats["compile_count"],
                  "recompiles_after_warmup": stats["recompiles_after_warmup"],
                  "http": {"tokens": len(over_http["tokens"]), "seconds": http_s,
                           "equals_handle_stream": over_http["tokens"] == greedy[2]},
                  "in_process_serve_phase": serve_summary, "nvidia_smi": smi}
        emit(part_c)
        check(part_c["answered"] == SERVE_REQUESTS,
              f"every request finished with {SERVE_NEW_TOKENS} tokens: {part_c['answered']}")
        check(part_c["resumes"] == 0 and not any(restarts.values()),
              f"no replica restart (the health poll read the busy replica healthy): {restarts}")
        check(stats["blocks"]["used_blocks"] == 0, f"every block returned: {stats['blocks']}")
        check(stats["recompiles_after_warmup"] == 0, "no new shape after warmup")
        check(stats["prefix_cache"]["hits_total"] >= 1, "at least one prefix hit")
        check(stats["prefix_cache"]["cow_copies_total"] >= 1, "the COW path ran")
        check(info["cuda_visible_devices"] == "0", "the 7B replica holds GPU 0")
        check(part_c["http"]["tokens"] == SERVE_NEW_TOKENS,
              f"a request over HTTP got {SERVE_NEW_TOKENS} tokens")

        # phase ingress (b): the door in front of this replica under the
        # seeded trace, then the ingress path's launches
        ingress_7b(rt, serve, handle, "llm7b", smi)
        info_7b = rt.get(handle.method("testing_device_info")(), timeout=60)
        ingress_launches = {
            k: (flash_launches(A)[k] - ingress_here0[k]
                + ingress_bound1["flash_launches"][k] - ingress_bound0["flash_launches"][k]
                + info_7b["flash_launches"][k])
            for k in ingress_here0}
        emit({"phase": "ingress", "part": "c_launches", "launches": ingress_launches,
              "this_process": flash_launches(A),
              "replicas": [ingress_bound1["flash_launches"], info_7b["flash_launches"]],
              "door_replicas": "no libcuda.so mapped (checked in (a) and (b))"})
        check(sum(ingress_launches.values()) == 0, "the ingress path launches no flash kernel")

        # (d) drain with live streams: each finishes, no error
        t0 = time.perf_counter()
        started = threading.Barrier(SD_DRAIN_STREAMS + 1, timeout=300)
        drained, errors = {}, []

        def consume(i):
            try:
                prompt, kw = results[8 + i][0], results[8 + i][1]
                it = iter(handle.stream({"prompt": prompt, "request_id": f"drain{i}", **kw},
                                        _method="generate", _timeout=600))
                first = next(it)
                started.wait()
                drained[i] = [first] + list(it)
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append(repr(e))
                started.abort()

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(SD_DRAIN_STREAMS)]
        for t in threads:
            t.start()
        started.wait()
        rt.get(handle.method("begin_drain")(30.0), timeout=60)
        for t in threads:
            t.join(timeout=300)
        stats_d = rt.get(handle.method("engine_stats")(), timeout=60)
        info_d = rt.get(handle.method("testing_device_info")(), timeout=60)
        part_d = {"phase": "serve_deployment", "part": "d_drain", "streams": SD_DRAIN_STREAMS,
                  "lengths": [len(drained.get(i, ())) for i in range(SD_DRAIN_STREAMS)],
                  "errors": errors, "draining": stats_d["draining"],
                  "running": stats_d["scheduler"]["running"],
                  "used_blocks": stats_d["blocks"]["used_blocks"],
                  "seconds": time.perf_counter() - t0}
        emit(part_d)
        check(not errors and part_d["lengths"] == [SERVE_NEW_TOKENS] * SD_DRAIN_STREAMS,
              f"every live stream finished through the drain: {part_d}")
        check(stats_d["draining"] is True and part_d["running"] == 0
              and part_d["used_blocks"] == 0, f"the engine drained clean: {part_d}")
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
        replica_launches = flash_a + [info_d["flash_launches"]]
        emit({"phase": "serve_deployment", "part": "launches", "this_process": launches,
              "replicas": replica_launches})
        check(sum(launches.values()) == 0 and
              all(sum(r.values()) == 0 for r in replica_launches),
              "the deployment path launches no flash kernel")

        # (e) shutdown, with the serve controller and the replica alive
        pids = find_runtime_pids(spawner_pid=os.getpid())
        serve.shutdown()
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "serve_deployment", "part": "e_shutdown", "processes_before": len(pids),
          "left_after": left, "seconds": time.perf_counter() - t_phase})
    check(len(pids) >= 2 and not left,
          f"no process of the cluster ({len(pids)} before) survives shutdown: {left}")
    return kill_gap_s, ingress_launches


# ---------------------------------------------------------------------------
# 10. kv_migration: prefill_export -> kv_import handoffs and the KV tier


#: (a): the f32 handoffs, then one refused descriptor per wrong field
KV_F32_HANDOFFS = 8
#: (b): the 7B handoffs and each stream's new tokens
KV_7B_HANDOFFS, KV_NEW_TOKENS = 16, 16
#: (c): the shared prefix (3 blocks of 16) of the streams the kill cuts
KV_SHARED = 48


def first_split(a, b):
    """The first position where two token lists differ (None: equal)."""
    return next((i for i, (p, q) in enumerate(zip(a, b)) if p != q),
                None if len(a) == len(b) else min(len(a), len(b)))


def odd_lens(rs, lo, hi, n):
    """``n`` prompt lengths in [lo, hi], none a whole number of blocks."""
    return [int(x) + 1 if x % 16 == 0 else int(x) for x in rs.randint(lo, hi + 1, size=n)]


def kv_requests(rs, vocab, lens, tag, new_tokens):
    """Even requests greedy, odd ones seeded at temperature 0.8."""
    return [dict(prompt=[int(t) for t in rs.randint(1, vocab, size=n)], max_new_tokens=new_tokens,
                 request_id=f"{tag}{i}",
                 **({} if i % 2 == 0 else dict(temperature=0.8, seed=500 + i)))
            for i, n in enumerate(lens)]


def kv_handoff_f32(torch, L, smi):
    """(a) f32 at 2 layers with no cluster (descriptors carry the payload
    inline): each request exported by A and imported by B must stream
    what a plain server streams, byte for byte, with B's prefix hit
    covering the exported tokens; then a descriptor with a wrong host
    type, a wrong block size or a wrong digest must be refused, counted
    as a fallback, and still give the plain stream."""
    import gc

    import numpy as np
    from ray_tpu_torch.inference import EngineConfig, LLMServer, kv_transfer

    t0 = time.perf_counter()
    cfg = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
    ec = EngineConfig(**LLM_F32_ENGINE, kv_transfer_enabled=True)
    a, b, plain = (LLMServer(cfg, ec, seed=1, export_metrics=False) for _ in range(3))
    rs = np.random.RandomState(43)
    reqs = kv_requests(rs, cfg.vocab_size, odd_lens(rs, 40, 200, KV_F32_HANDOFFS + 3), "f",
                       KV_NEW_TOKENS)
    m = kv_transfer.migration_metrics()
    fb = m["fallbacks"]._values
    transfers0, fallbacks0 = m["transfers"]._values.get((), 0.0), sum(fb.values())
    rows = []
    for r in reqs[:KV_F32_HANDOFFS]:
        want = plain(r)["tokens"]
        desc = a.prefill_export(r)
        saved0 = b.engine.blocks.prefix_tokens_saved_total
        got = b({**r, "kv_import": desc})["tokens"]
        rows.append({"prompt_len": len(r["prompt"]), "temperature": r.get("temperature", 0.0),
                     "exported_tokens": desc["tokens"], "inline": desc["inline"] is not None,
                     "prefix_hit_tokens": b.engine.blocks.prefix_tokens_saved_total - saved0,
                     "equal": got == want})
    transfers = m["transfers"]._values.get((), 0.0) - transfers0
    fallbacks = sum(fb.values()) - fallbacks0
    refusals = []
    for r, (field, bad, reason) in zip(reqs[KV_F32_HANDOFFS:], (
            ("dtype", "uint16", "shape_mismatch"), ("block_size", 32, "shape_mismatch"),
            ("crc32", None, "transfer"))):
        desc = a.prefill_export(r)
        wrong = {**desc, field: desc["crc32"] ^ 0xFF if bad is None else bad}
        before, saved0 = fb.get((reason,), 0.0), b.engine.blocks.prefix_tokens_saved_total
        got = b({**r, "kv_import": wrong})["tokens"]
        refusals.append({"field": field, "reason": reason,
                         "counted": fb.get((reason,), 0.0) - before,
                         "prefix_hit_tokens": b.engine.blocks.prefix_tokens_saved_total - saved0,
                         "equal": got == plain(r)["tokens"]})
    part = {"phase": "kv_migration", "part": "a_handoff_f32",
            "config": "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)",
            "reduced": ["n_layers 32 -> 2"], "tf32": False,
            "engine": dict(LLM_F32_ENGINE, kv_transfer_enabled=True), "handoffs": rows,
            "equal": sum(r["equal"] for r in rows), "transfers": transfers,
            "fallbacks": fallbacks, "refusals": refusals,
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part)
    check(part["equal"] == KV_F32_HANDOFFS,
          f"every f32 handoff streams the plain stream byte for byte: {rows}")
    check(all(r["prefix_hit_tokens"] == r["exported_tokens"] > 0 for r in rows),
          f"B's prefix hit covers every descriptor's tokens: {rows}")
    check(all(r["inline"] for r in rows), "with no cluster the payload rides the descriptor")
    check(transfers == KV_F32_HANDOFFS and fallbacks == 0,
          f"{KV_F32_HANDOFFS} transfers and no fallback: {transfers}, {fallbacks}")
    check(all(r["counted"] == 1 and r["prefix_hit_tokens"] == 0 and r["equal"]
              for r in refusals), f"each wrong descriptor is refused and counted: {refusals}")
    del a, b, plain
    gc.collect()
    torch.cuda.empty_cache()


def kv_handoff_7b(torch, L, smi):
    """(b) full Llama-2-7B in bf16, the driver on the port's cluster (so
    ``publish`` and ``fetch`` go through the node daemon's shared memory):
    A exports, B imports and decodes, C (the same configuration) serves
    the same request cold. After each handoff the cache blocks that hold
    the exported prefix are compared bit for bit on the card: B's (the
    imported ones) with A's, and with C's (A and C prefill with the same
    buckets). Returns the TTFT quantiles."""
    import gc

    import numpy as np
    from ray_tpu_torch.inference import EngineConfig, LLMServer, kv_transfer
    from ray_tpu_torch.observability import slo

    cfg = L.LlamaConfig.llama2_7b()
    params = L.init_params(cfg, 0)
    t0 = time.perf_counter()
    ec = EngineConfig(**SERVE_ENGINE, kv_transfer_enabled=True)
    a, b, c = (LLMServer(cfg, ec, params=params, export_metrics=False) for _ in range(3))
    warmup_s = time.perf_counter() - t0
    rs = np.random.RandomState(47)
    reqs = kv_requests(rs, cfg.vocab_size, [int(n) for n in rs.randint(256, 1025, size=KV_7B_HANDOFFS)],
                       "b", KV_NEW_TOKENS)
    # the ledger stages of this part's requests, all of them kept
    slo._RECORDER = slo.FlightRecorder(slow_slots=4 * KV_7B_HANDOFFS)
    # time publish and fetch where LLMServer calls them
    timings = {"publish": [], "fetch": []}
    originals = {name: getattr(kv_transfer, name) for name in timings}

    def timed(name):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return originals[name](*args, **kw)
            finally:
                timings[name].append(time.perf_counter() - t)
        return call

    m = kv_transfer.migration_metrics()
    transfers0 = m["transfers"]._values.get((), 0.0)
    fallbacks0 = sum(m["fallbacks"]._values.values())
    rows, streams = [], []
    for name in timings:
        setattr(kv_transfer, name, timed(name))
    try:
        for i, r in enumerate(reqs):
            t = time.perf_counter()
            first, cold = None, []
            for chunk in c.generate({**r, "request_id": f"c{i}"}):
                first = first or time.perf_counter()
                cold += chunk
            ttft_cold = first - t
            t = time.perf_counter()
            desc = a.prefill_export({**r, "request_id": f"x{i}"})
            t_b = time.perf_counter()
            saved0 = b.engine.blocks.prefix_tokens_saved_total
            first, got = None, []
            for chunk in b.generate({**r, "request_id": f"h{i}", "kv_import": desc}):
                first = first or time.perf_counter()
                got += chunk
            prefix = r["prompt"][: desc["tokens"]]
            ids = {k: prefix_blocks(s, prefix) for k, s in (("a", a), ("b", b), ("c", c))}
            stages = {e["request_id"]: e["stages"] for e in slo.flight_recorder().snapshot()}
            n, export_s = desc["size"], stages[f"x{i}"]["kv_export"]
            import_s, fetch_s = stages[f"h{i}"]["kv_import"], timings["fetch"][-1]
            rows.append({
                "prompt_len": len(r["prompt"]), "temperature": r.get("temperature", 0.0),
                "exported_blocks": desc["shape"][2], "exported_tokens": desc["tokens"],
                "bytes": n, "through_store": desc["object_id"] is not None,
                "prefix_hit_tokens": b.engine.blocks.prefix_tokens_saved_total - saved0,
                "kv_export_ms": export_s * 1e3, "publish_ms": timings["publish"][-1] * 1e3,
                "fetch_ms": fetch_s * 1e3, "kv_import_ms": import_s * 1e3,
                "gather_gbps": n / export_s / 1e9, "publish_gbps": n / timings["publish"][-1] / 1e9,
                "scatter_gbps": n / max(import_s - fetch_s, 1e-9) / 1e9,
                "ttft_b_s": first - t_b, "ttft_handoff_s": first - t, "ttft_cold_s": ttft_cold,
                "tokens": len(got), "first_split": first_split(got, cold),
                "blocks_b_equal_a": blocks_equal(torch, b, a, ids["b"], ids["a"]),
                "blocks_b_equal_c": blocks_equal(torch, b, c, ids["b"], ids["c"])})
            streams.append((got, cold))
    finally:
        for name, fn in originals.items():
            setattr(kv_transfer, name, fn)
    transfers = m["transfers"]._values.get((), 0.0) - transfers0
    fallbacks = sum(m["fallbacks"]._values.values()) - fallbacks0
    servers = {"a": a, "b": b, "c": c}
    for s in servers.values():
        s.engine.wait_idle(60)
    used = {k: s.engine.blocks.used_blocks for k, s in servers.items()}
    shapes = {k: s.engine.runner.recompiles_after_warmup() for k, s in servers.items()}

    def q(key):
        return quantiles([r[key] for r in rows])

    part = {"phase": "kv_migration", "part": "b_handoff_7b", "config": "LlamaConfig.llama2_7b()",
            "reduced": [], "engine": dict(SERVE_ENGINE, kv_transfer_enabled=True),
            "new_tokens": KV_NEW_TOKENS, "warmup_s_three_servers": warmup_s,
            "handoffs": rows,
            # a prompt of whole blocks recomputes its last token (COW)
            "migration_used": sum(r["prefix_hit_tokens"] == r["exported_tokens"]
                                  - (r["prompt_len"] == r["exported_tokens"]) > 0 for r in rows),
            "transfers": transfers, "fallbacks": fallbacks,
            **{k: q(k) for k in ("exported_blocks", "bytes", "kv_export_ms", "publish_ms",
                                 "fetch_ms", "kv_import_ms", "gather_gbps", "publish_gbps",
                                 "scatter_gbps", "ttft_b_s", "ttft_handoff_s", "ttft_cold_s")},
            "streams_equal_cold": sum(r["first_split"] is None for r in rows),
            "first_splits": [r["first_split"] for r in rows if r["first_split"] is not None],
            # the imported prefix, bit for bit: B against the exporter A
            # (the handoff) and against the cold server C (the prefill)
            "prefix_blocks_b_equal_a": sum(r["blocks_b_equal_a"] for r in rows),
            "prefix_blocks_b_equal_c": sum(r["blocks_b_equal_c"] for r in rows),
            "split_with_prefix_equal_c": sum(r["first_split"] is not None and r["blocks_b_equal_c"]
                                             for r in rows),
            "used_blocks": used, "recompiles_after_warmup": shapes,
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi}
    emit(part)
    check(part["migration_used"] == KV_7B_HANDOFFS and all(r["through_store"] for r in rows),
          f"every 7B handoff went through the store and B's prefix hit: {part['migration_used']}")
    check(transfers == KV_7B_HANDOFFS and fallbacks == 0,
          f"{KV_7B_HANDOFFS} transfers and no fallback: {transfers}, {fallbacks}")
    check(part["prefix_blocks_b_equal_a"] == KV_7B_HANDOFFS,
          "every imported bf16 prefix is bit for bit the exporter's blocks: "
          f"{[r['blocks_b_equal_a'] for r in rows]}")
    check(all(len(got) == KV_NEW_TOKENS == len(cold) for got, cold in streams),
          f"every stream has {KV_NEW_TOKENS} tokens")
    check(used == {"a": 0, "b": 0, "c": 0}, f"every block came back in each pool: {used}")
    check(shapes == {"a": 0, "b": 0, "c": 0}, f"no new shape after warmup: {shapes}")
    del a, b, c, servers, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: part[k] for k in ("ttft_b_s", "ttft_cold_s")}


def prefix_blocks(server, tokens):
    """The cache blocks a server's prefix index holds for the full blocks
    of ``tokens`` (None for one it does not hold)."""
    bm = server.engine.blocks
    with bm._lock:
        return [bm._index.get(d) for d in chain_digests(tokens, bm.block_size)]


def blocks_equal(torch, s, t, ids_s, ids_t) -> bool:
    """Whether blocks ``ids_s`` of server ``s``'s cache hold the same bits
    as blocks ``ids_t`` of ``t``'s, K and V, on the card."""
    if None in ids_s or None in ids_t or len(ids_s) != len(ids_t):
        return False
    cs, ct = s.engine.runner.cache, t.engine.runner.cache
    with torch.inference_mode():
        for key in ("k", "v"):
            x, y = cs[key][:, ids_s], ct[key][:, ids_t]
            bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
            if not torch.equal(x.view(bits), y.view(bits)):
                return False
    return True


def metric_total(replica_info, name) -> float:
    """A counter family's total on a replica's own /metrics endpoint."""
    import urllib.request

    body = urllib.request.urlopen(f"http://{replica_info}/metrics", timeout=30).read().decode()
    return sum(float(line.rsplit(" ", 1)[1]) for line in body.splitlines()
               if line.startswith(name) and " " in line)


def kv_tier_cluster(torch, L, smi, sd_gap_s):
    """(c) ``llm_deployment(kv_tier=True)`` with one ``num_gpus=1`` replica,
    f32 at 2 layers: (i) the replica SIGKILLed mid-decode under 4 streams
    sharing a 3-block prefix; the replacement re-adopts the tier and the
    streams resume by fault-in; (ii) that replica unrouted (scaled to 0),
    drained with ``migrate=True`` under 2 live streams (one decoding, one
    mid-prefill under a 0.5 s stall), reaped, and the deployment scaled
    back to 1: the streams finish on the new replica."""
    import gc
    import threading

    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.inference import EngineConfig, LLMServer, kv_transfer
    from ray_tpu_torch.observability.rpc_metrics import (
        STREAM_RESUME_REPLAY_TOKENS,
        STREAM_RESUMES,
    )
    from ray_tpu_torch.serve.controller import get_or_create_controller

    t0 = time.perf_counter()
    cfg = L.LlamaConfig.llama2_7b(n_layers=2, dtype=torch.float32)
    rs = np.random.RandomState(53)
    shared = [int(t) for t in rs.randint(1, cfg.vocab_size, size=KV_SHARED)]
    kill_reqs = [dict(prompt=shared + [int(t) for t in rs.randint(1, cfg.vocab_size, size=2)],
                      max_new_tokens=16, request_id=f"t{i}",
                      **({} if i % 2 == 0 else dict(temperature=0.8, seed=600 + i)))
                 for i in range(4)]
    drain_reqs = [dict(prompt=shared + [7, 9], max_new_tokens=16, request_id="d0"),
                  dict(prompt=[int(t) for t in rs.randint(1, cfg.vocab_size, size=2000)],
                       max_new_tokens=16, request_id="d1", temperature=0.8, seed=611)]
    local = LLMServer(cfg, EngineConfig(**LLM_F32_ENGINE), seed=1, export_metrics=False)
    try:
        undisturbed = [flat(local.generate(r)) for r in kill_reqs + drain_reqs]
    finally:
        local.engine.stop()
    del local
    gc.collect()
    torch.cuda.empty_cache()

    def deployment(n):
        return serve.llm_deployment(cfg, engine=EngineConfig(**LLM_F32_ENGINE), name="llmtier",
                                    route_prefix="/llmtier", seed=1, version="v1", kv_tier=True,
                                    num_replicas=n, max_concurrent_queries=8,
                                    ray_actor_options={"num_gpus": 1})

    ctrl = get_or_create_controller()
    handle = serve.run(deployment(1).bind())
    ready_s = time.perf_counter() - t0
    (first,) = rt.get(ctrl.get_replicas.remote("llmtier"), timeout=60)
    info0 = rt.get(handle.method("testing_device_info")(), timeout=60)
    # a warm request publishes the shared blocks; the gossip carries them
    # to the router before the kill
    sd_stream(handle, {"prompt": shared + [5], "max_new_tokens": 2})
    time.sleep(1.0)
    adverts0 = rt.get(handle.method("routing_stats")(), timeout=60)["kv_tier"]

    def in_threads(requests):
        out, errors = [None] * len(requests), []

        def run(i):
            try:
                out[i] = sd_stream(handle, requests[i])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        return threads, out, errors

    def joined(threads, out, errors):
        for th in threads:
            th.join(timeout=300)
        check(not any(th.is_alive() for th in threads), "client threads finished")
        if errors:
            raise errors[0]
        return out

    # (i) SIGKILL mid-decode under 4 streams
    t1 = time.perf_counter()
    resumes0 = STREAM_RESUMES._values.get(("llmtier",), 0.0)
    replay0 = STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0)
    rt.get(handle.method("testing_arm_replica_chaos")(CHAOS_SPEC, CHAOS_SEED), timeout=60)
    killed = joined(*in_threads(kill_reqs))
    status = rt.get(ctrl.wait_status.remote("llmtier", min_replicas=1, timeout_s=300), timeout=330)
    (second,) = rt.get(ctrl.get_replicas.remote("llmtier"), timeout=60)
    info1 = rt.get(handle.method("testing_device_info")(), timeout=60)
    stats1 = rt.get(handle.method("engine_stats")(), timeout=60)
    adverts1 = rt.get(handle.method("routing_stats")(), timeout=60)["kv_tier"]
    addr1 = rt.get(handle.method("metrics_address")(), timeout=60)
    hits1 = metric_total(addr1, "raytpu_kv_tier_hits_total")
    publishes1 = metric_total(addr1, "raytpu_kv_tier_publishes_total")
    # full blocks of each stream past the shared prefix: all a replacement
    # that re-adopted the tier may publish (one that did not would publish
    # the shared chain's 3 blocks as well)
    own_blocks = sum((len(r["prompt"]) + r["max_new_tokens"] - 1) // 16 - KV_SHARED // 16
                     for r in kill_reqs)
    gaps = [max(b - a for a, b in zip(ts, ts[1:])) for _, ts in killed]
    chain = [d.hex() for d in chain_digests(shared, 16)]
    part_i = {"phase": "kv_migration", "part": "c1_tier_fault_in",
              "config": "LlamaConfig.llama2_7b(n_layers=2, dtype=float32)",
              "reduced": ["n_layers 32 -> 2"], "engine": dict(LLM_F32_ENGINE, kv_tier_enabled=True),
              "deploy_to_ready_s": ready_s, "spec": CHAOS_SPEC, "seed": CHAOS_SEED,
              "adverts_before_kill": len(adverts0),
              "streams_equal": [t == u for (t, _), u in zip(killed, undisturbed[:4])],
              "resumes": STREAM_RESUMES._values.get(("llmtier",), 0.0) - resumes0,
              "router_replay_tokens": STREAM_RESUME_REPLAY_TOKENS._values.get((), 0.0) - replay0,
              "restarts": status["restarts"], "replacement": {k: info1[k] for k in (
                  "pid", "cuda_visible_devices", "device", "init_s")},
              "killed_pid_gone": rt_pid_gone(info0["pid"]),
              "replacement_adverts": len(adverts1),
              "shared_chain_adverted": all(d in adverts1 for d in chain),
              "replacement_publishes": publishes1, "streams_own_full_blocks": own_blocks,
              "replacement_tier_hits": hits1,
              "replacement_prefix_tokens_saved": stats1["prefix_cache"]["tokens_saved_total"],
              "prompt_tokens": sum(len(r["prompt"]) for r in kill_reqs),
              "kill_to_first_resumed_token_s": quantiles(gaps),
              "serve_deployment_b_kill_to_first_resumed_token_s": sd_gap_s,
              "seconds": time.perf_counter() - t1, "nvidia_smi": smi}
    emit(part_i)
    check(all(part_i["streams_equal"]), "the resumed f32 streams equal the undisturbed ones")
    check(part_i["resumes"] >= 1 and status["restarts"].get("death") == 1
          and part_i["killed_pid_gone"] and info1["pid"] != info0["pid"],
          f"the kill landed mid-stream and the controller replaced the replica: {status}")
    check(info1["device"] == "cuda:0", "the replacement holds the card")
    check(part_i["shared_chain_adverted"] and publishes1 <= own_blocks,
          "the replacement re-adopted the tier (_tier_recover): it adverts the shared chain and "
          f"published {publishes1} blocks, no more than the streams' own {own_blocks}")
    check(hits1 > 0, "the replacement faulted tier blocks in")
    check(part_i["replacement_prefix_tokens_saved"] >= KV_SHARED * len(kill_reqs),
          "each resumed stream admitted its shared prefix warm: replayed prefill < prompt")

    # (ii) unroute, drain with migrate=True under 2 live streams, reap,
    # and scale back to 1
    t2 = time.perf_counter()
    resumes0 = STREAM_RESUMES._values.get(("llmtier",), 0.0)
    rt.get(handle.method("testing_arm_replica_chaos")("stall:1.0:0.5:9999", 3), timeout=60)
    threads, out, errors = in_threads(drain_reqs[:1])
    time.sleep(1.5)  # d0 decoding
    more = in_threads(drain_reqs[1:])
    time.sleep(2.5)  # d1's 8 prefill chunks take about 8 s under the stall
    serve.run(deployment(0).bind(), _blocking_ready=False)
    deadline = time.monotonic() + 30
    # unrouted at the controller and in this handle's router, so the
    # resumes wait for a new replica instead of meeting the drained one
    while rt.get(ctrl.get_replicas.remote("llmtier"), timeout=60) or handle._router._replicas:
        check(time.monotonic() < deadline, "the replica was unrouted")
        time.sleep(0.05)
    rt.get(second.handle_request.remote("begin_drain", [30.0, True], {}, ""), timeout=60)
    serve.run(deployment(1).bind(), _blocking_ready=False)
    # d1 never finished its prefill on that replica, so only the drain's
    # migration can have put its first chunk's blocks into the tier
    ns = adverts1[chain[0]]["tier_ns"]
    d1_chain = [d.hex() for d in chain_digests(drain_reqs[1]["prompt"][:256], 16)]
    migrated, migrate_publishes, deadline = [], None, time.monotonic() + 30
    while time.monotonic() < deadline:
        migrated = [d for d in d1_chain if d in kv_transfer.tier_list(ns=ns)]
        try:  # the drained replica's own count, while it still lives
            migrate_publishes = metric_total(
                addr1, 'raytpu_kv_tier_publishes_total{trigger="migrate"}')
        except OSError:
            pass
        if len(migrated) == len(d1_chain):
            break
        time.sleep(0.1)
    drained = joined(threads, out, errors) + joined(*more)
    status = rt.get(ctrl.wait_status.remote("llmtier", min_replicas=1, timeout_s=300), timeout=330)
    info2 = rt.get(handle.method("testing_device_info")(), timeout=60)
    addr2 = rt.get(handle.method("metrics_address")(), timeout=60)
    part_ii = {"phase": "kv_migration", "part": "c2_drain_migrate", "streams": len(drain_reqs),
               "prompt_lens": [len(r["prompt"]) for r in drain_reqs],
               "streams_equal": [t == u for (t, _), u in zip(drained, undisturbed[4:])],
               "lengths": [len(t) for t, _ in drained],
               "resumes": STREAM_RESUMES._values.get(("llmtier",), 0.0) - resumes0,
               "mid_prefill_blocks_migrated": len(migrated), "of": len(d1_chain),
               "drained_pid_gone": rt_pid_gone(info1["pid"]),
               "new_replica": {k: info2[k] for k in ("pid", "cuda_visible_devices", "device")},
               "drained_replica_migrate_publishes_last_read": migrate_publishes,
               "new_replica_tier_hits": metric_total(addr2, "raytpu_kv_tier_hits_total"),
               "restarts": status["restarts"], "seconds": time.perf_counter() - t2}
    emit(part_ii)
    check(all(part_ii["streams_equal"]) and part_ii["lengths"] == [16, 16],
          f"the drained streams finished on the new replica, equal: {part_ii}")
    check(part_ii["resumes"] == 2 and part_ii["drained_pid_gone"]
          and info2["pid"] not in (info0["pid"], info1["pid"]),
          "both streams resumed on a new replica after the drained one was reaped")
    check(part_ii["mid_prefill_blocks_migrated"] == len(d1_chain),
          f"the drain migrated the mid-prefill stream's written blocks: {part_ii}")
    check(part_ii["new_replica_tier_hits"] > 0, "the decoding stream resumed by tier fault-in")
    serve.delete("llmtier")
    wait_gpu_back(rt)
    return [info0["flash_launches"], info1["flash_launches"], info2["flash_launches"]]


def chain_digests(tokens, bs):
    """Full-block chain digests of ``tokens`` (the tier's key space)."""
    from ray_tpu_torch.inference.kv_cache import _chain_digest

    out, prev = [], b""
    for end in range(bs, len(tokens) + 1, bs):
        prev = _chain_digest(prev, tokens[end - bs : end])
        out.append(prev)
    return out


def phase_kv_migration(torch, A, L, smi: str, sd_gap_s):
    """KV migration and the cluster KV tier: (a) f32 handoffs in the
    driver, (b) full Llama-2-7B bf16 handoffs through the node daemon's
    shared memory, (c) the tier through ``llm_deployment(kv_tier=True)``
    on the port's cluster. The path launches no flash kernel."""
    import gc
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' engines and caches are gone
    t_phase = time.perf_counter()
    A.reset_launch_counts()  # the kv_migration path's run starts here
    kv_handoff_f32(torch, L, smi)
    try:
        rt.init(num_cpus=4)
        kv_handoff_7b(torch, L, smi)
        replica_launches = kv_tier_cluster(torch, L, smi, sd_gap_s)
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
        pids = find_runtime_pids(spawner_pid=os.getpid())
        serve.shutdown()
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "kv_migration", "part": "launches", "this_process": launches,
          "replicas": replica_launches, "processes_before": len(pids), "left_after": left,
          "seconds": time.perf_counter() - t_phase})
    check(sum(launches.values()) == 0 and all(sum(r.values()) == 0 for r in replica_launches),
          "the kv_migration path launches no flash kernel")
    check(not left, f"no process of the cluster survives shutdown: {left}")


# ---------------------------------------------------------------------------
# 11. train


#: (a) the resumed f32 run: tiny Llama, steps, rows a step, a checkpoint
#: every TRAIN_A_EVERY steps, the worker dying before TRAIN_A_FAIL once
TRAIN_A_STEPS, TRAIN_A_ROWS, TRAIN_A_SEQ, TRAIN_A_EVERY, TRAIN_A_FAIL = 8, 4, 64, 2, 5
#: bf16 tolerance of a loss against another path's (relative, 2^-8)
BF16_LOSS_RTOL = 2.0 ** -8


def train_fit(loop_config, rows, name, storage, **run):
    """One ``TorchTrainer`` fit of ``llama_train_loop`` on one GPU worker
    (nccl world 1, ``MeshSpec(fsdp=-1)``, fsdp rules) over ``rows``."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.tools.train_llama import llama_train_loop
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    trainer = TorchTrainer(
        llama_train_loop, train_loop_config=loop_config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        backend_config=TorchBackendConfig(mesh_spec=MeshSpec(fsdp=-1), sharding="fsdp"),
        run_config=RunConfig(name=name, storage_path=storage, **run),
        datasets={"train": rd.from_numpy(rows, block_size=loop_config["batch_size"])})
    return trainer.fit()


def train_worker_checks(done, what):
    check(done.get("done") is True, f"{what}: the worker's last report: {done}")
    check(done["device_count"] == 1 and done["cuda_visible_devices"] not in (None, ""),
          f"{what}: the worker sees one GPU it was leased: {done}")
    check(done["backend"] == "nccl" and done["world_size"] == 1,
          f"{what}: the worker's process group is nccl, world 1: {done}")


def train_resume_f32(torch, L, smi, storage):
    """(a) tiny f32 through the trainer, the worker killed before step 5 on
    its first attempt and resumed from a checkpoint, against the same step
    run uninterrupted in this process."""
    import numpy as np

    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import fsdp_rules
    from ray_tpu_torch.train import CheckpointConfig, FailureConfig

    rows = np.random.RandomState(10).randint(
        0, 256, size=(TRAIN_A_STEPS * TRAIN_A_ROWS, TRAIN_A_SEQ + 1))
    loop = {"model": {"preset": "tiny", "dtype": "float32"}, "seed": 0, "lr": 1e-3,
            "remat": "selective", "batch_size": TRAIN_A_ROWS,
            "checkpoint_every": TRAIN_A_EVERY, "fail_at_step": TRAIN_A_FAIL}
    t0 = time.perf_counter()
    result = train_fit(loop, rows, "train_a", storage,
                       checkpoint_config=CheckpointConfig(num_to_keep=2),
                       failure_config=FailureConfig(max_failures=1))
    fit_s = time.perf_counter() - t0
    done = result.metrics
    final = result.checkpoint.to_dict()
    kept = sorted(p.name for p in Path(result.path).glob("checkpoint_*"))
    # uninterrupted, in this process: the same call on a world-1 nccl mesh
    cfg = L.LlamaConfig.tiny(dtype=torch.float32)
    mesh, rules = make_mesh(MeshSpec(fsdp=-1)), fsdp_rules()
    state = L.init_sharded(cfg, mesh, rules, 0, L.adamw(1e-3))
    step = L.make_train_step(cfg, remat="selective", mesh=mesh, rules=rules)
    ref = []
    for i in range(TRAIN_A_STEPS):
        r = torch.from_numpy(rows[i * TRAIN_A_ROWS:(i + 1) * TRAIN_A_ROWS]).cuda()
        state, loss = step(state, {"tokens": r[:, :-1], "targets": r[:, 1:]})
        ref.append(float(loss))
    losses = final["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    history = [m["step"] for m in result.metrics_history if "loss" in m]
    emit({"phase": "train", "part": "a_resume_f32", "config": "LlamaConfig.tiny f32, TF32 off",
          "steps": TRAIN_A_STEPS, "rows_per_step": TRAIN_A_ROWS, "seq": TRAIN_A_SEQ,
          "fail_before_step": TRAIN_A_FAIL, "resumed_history_steps": history,
          "losses": losses, "uninterrupted_losses": ref, "max_rel_diff": rel,
          "checkpoints_kept": kept, "worker": done, "fit_s": fit_s, "nvidia_smi": smi})
    check(len(losses) == TRAIN_A_STEPS and rel <= 1e-6,
          f"resumed losses equal the uninterrupted run within 1e-6: {rel}")
    check(history == list(range(TRAIN_A_FAIL - 1, TRAIN_A_STEPS)),
          f"the second attempt resumed from the step-{TRAIN_A_FAIL - 1} checkpoint: {history}")
    check(len(kept) == 2 and final["step"] == TRAIN_A_STEPS, f"two checkpoints kept: {kept}")
    train_worker_checks(done, "train (a)")


def slice_rows(torch, steps):
    """Phase ``slice``'s batch (``slice_batch(0)``) as host token rows, once
    for each of ``steps`` steps: a dataset a trainer worker reads."""
    import numpy as np

    from ray_tpu_torch.tools.profile_train_step import slice_batch

    b = slice_batch(0)
    seqs = torch.cat([b["tokens"], b["targets"][:, -1:]], dim=1).cpu().numpy()
    return np.concatenate([seqs] * steps)


def slice_loop(lr):
    """``llama_train_loop``'s config for phase ``slice``'s model at ``lr``:
    the seed, batch and depth of the slice, fsdp rules, selective remat."""
    from ray_tpu_torch.tools.profile_train_step import SLICE

    return {"model": {"preset": "llama2_7b", "n_layers": SLICE["n_layers"]}, "seed": 0,
            "lr": lr, "remat": "selective", "batch_size": SLICE["batch"]}


def train_7b(torch, L, smi, storage, slice_summary):
    """(b) the slice's config, params and batch through the trainer: one
    warm and 3 timed steps of the sharded step with selective remat.
    Returns its losses."""
    from ray_tpu_torch.tools.profile_train_step import SLICE

    n_layers, steps = SLICE["n_layers"], 4
    loop = slice_loop(SLICE["lr"])
    t0 = time.perf_counter()
    result = train_fit(loop, slice_rows(torch, steps), "train_b", storage)
    fit_s = time.perf_counter() - t0
    done = result.metrics
    hist = [m for m in result.metrics_history if "loss" in m]
    losses = [m["loss"] for m in hist]
    step_ms = sum(m["step_ms"] for m in hist[1:]) / (steps - 1)
    tokens = SLICE["batch"] * SLICE["seq"]
    ref = slice_summary["losses"]  # the same params and batch, every step
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    want = n_layers * steps
    emit({"phase": "train", "part": "b_7b_bf16",
          "config": f"LlamaConfig.llama2_7b(n_layers={n_layers}) bf16",
          "reduced": [f"n_layers 32 -> {n_layers}"], "batch": SLICE["batch"], "seq": SLICE["seq"],
          "mesh": done.get("mesh"), "sharding": "fsdp", "remat": "selective",
          "losses": losses, "slice_losses": ref, "max_rel_diff_vs_slice": rel,
          "step_ms": step_ms, "step_ms_each": [m["step_ms"] for m in hist],
          "tokens_per_s": tokens / (step_ms / 1e3),
          "slice_step_ms": slice_summary["step_ms"],
          "trainer_over_slice": step_ms / slice_summary["step_ms"],
          "worker_max_memory_allocated_bytes": done.get("max_memory_allocated_bytes"),
          "worker_launches": done.get("launches"),
          "worker_launches_by_route": done.get("launches_by_route"),
          "fit_s": fit_s, "nvidia_smi": smi})
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), f"losses: {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(len(ref) == steps and rel <= BF16_LOSS_RTOL,
          f"losses {losses} vs the slice's {ref}: largest relative difference {rel}")
    train_worker_checks(done, "train (b)")
    for name, n in done["launches"].items():
        check(n == want, f"worker {name} launched {n} times, expected {want}")
        check(done["launches_by_route"][name] == {"tensor_core": want, "cuda_core": 0},
              f"worker {name} by route {done['launches_by_route'][name]}")
    return losses


def train_remat_modes(torch, A, L, smi):
    """(c) the slice's step in this process under each remat mode, 2 steps
    each from the same params and batch."""
    from ray_tpu_torch.tools.profile_train_step import SLICE, train_slice

    n_layers, steps = SLICE["n_layers"], 2
    rows = {}
    for mode in (False, "selective", "full"):
        cfg, (model, opt), _, batch = train_slice(seed=0)
        step = L.make_train_step(cfg, remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()  # this mode's steps start here
        losses, ms = [], []
        state = (model, opt)
        for _ in range(steps):
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
        rows[str(mode)] = {"losses": losses, "step_ms": ms,
                           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                           "launches": launches}
        del state, model, opt, step
        gc_collect(torch)
    emit({"phase": "train", "part": "c_remat_modes",
          "config": f"LlamaConfig.llama2_7b(n_layers={n_layers}) bf16, unsharded",
          "batch": SLICE["batch"], "seq": SLICE["seq"], "modes": rows, "nvidia_smi": smi})
    fwd = {"False": n_layers, "selective": n_layers, "full": 2 * n_layers}
    for mode, r in rows.items():
        got = r["launches"]
        check(got["flash_fwd"] == fwd[mode] * steps,
              f"remat={mode}: forward launched {got['flash_fwd']}, expected {fwd[mode] * steps}")
        check(got["flash_bwd_dq"] == got["flash_bwd_dkv"] == n_layers * steps,
              f"remat={mode}: backward launches {got}")
        # step 1 follows an update, so it holds the backward and AdamW too
        ref = rows["False"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
        check(rel <= BF16_LOSS_RTOL, f"remat={mode}: losses {r['losses']} vs {ref}: {rel}")


def gc_collect(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_train(torch, A, L, smi: str, slice_summary: dict):
    """The training path through the trainer: (a) a resumed f32 run, (b)
    the slice at 7B width through ``TorchTrainer``, (c) remat modes.
    Returns (b)'s losses."""
    import os
    import tempfile

    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc_collect(torch)  # the earlier phases' engines and caches are gone
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_runs_") as storage:
        try:
            rt.init(num_cpus=4)
            train_resume_f32(torch, L, smi, storage)
            gc_collect(torch)
            losses_b = train_7b(torch, L, smi, storage, slice_summary)
        finally:
            rt.shutdown()
            if dist.is_initialized():
                dist.destroy_process_group()
    gc_collect(torch)
    train_remat_modes(torch, A, L, smi)
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "train", "part": "end", "left_after": left,
          "seconds": time.perf_counter() - t_phase})
    check(not left, f"no process of the cluster survives shutdown: {left}")
    return losses_b


# ---------------------------------------------------------------------------
# 12. moe


#: the expert phase's 7B-width config: the repo's own MoE defaults (top-2,
#: capacity factor 1.25, aux coefficient 0.01) over 8 experts, depth cut
MOE_EXPERTS, MOE_LAYERS = 8, 4
#: the f32 MoE FFN on the card against its CPU run, and the tiny step's
#: losses with the kernels against the plain attention
MOE_F32_ATOL, MOE_F32_LOSS_RTOL = 1e-5, 1e-5
MATMULS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def moe_tiny_f32(torch, L, smi):
    """(a) tiny f32: ``moe_ffn`` on the card against the same call on CPU
    copies of its inputs (uncapped and capped), and 3 steps of the tiny MoE
    Llama through the kernels against the plain attention."""
    from ray_tpu_torch.ops import moe as M

    cfg = L.LlamaConfig.tiny(moe_experts=4, max_seq_len=128)
    g = torch.Generator(device="cuda").manual_seed(5)
    params = M.init_moe_params(g, cfg.dim, cfg.mlp_hidden, cfg.moe_experts)
    x = torch.randn((2, 64, cfg.dim), generator=g, device="cuda")
    ffn = {}
    for cf in (8.0, 0.5):
        out, aux = M.moe_ffn(params, x, top_k=cfg.moe_top_k, capacity_factor=cf)
        ref, raux = M.moe_ffn({k: v.cpu() for k, v in params.items()}, x.cpu(),
                              top_k=cfg.moe_top_k, capacity_factor=cf)
        ffn[f"cf={cf}"] = {
            "out_max_abs_err": float((out.cpu() - ref).abs().max()),
            "aux_loss_abs_err": abs(float(aux["aux_loss"]) - float(raux["aux_loss"])),
            "dropped_fraction": float(aux["dropped_fraction"]),
            "cpu_dropped_fraction": float(raux["dropped_fraction"]),
        }
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=g, device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    losses = {}
    for impl in ("pallas", "xla"):
        c = L.LlamaConfig.tiny(moe_experts=4, max_seq_len=128, attention_impl=impl)
        model = L.init_params(c, 0)
        state, step = (model, L.adamw(1e-3)(model.parameters())), L.make_train_step(c)
        losses[impl] = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses[impl].append(float(loss))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["pallas"], losses["xla"]))
    emit({"phase": "moe", "part": "a_tiny_f32", "config": "LlamaConfig.tiny(moe_experts=4) f32",
          "tf32": False, "moe_ffn": ffn, "tol": MOE_F32_ATOL, "losses": losses,
          "loss_max_rel_diff": rel, "loss_rtol": MOE_F32_LOSS_RTOL, "nvidia_smi": smi})
    for case, r in ffn.items():
        check(max(r["out_max_abs_err"], r["aux_loss_abs_err"]) <= MOE_F32_ATOL,
              f"moe_ffn {case} on the card against the CPU: {r}")
        check(r["dropped_fraction"] == r["cpu_dropped_fraction"], f"moe_ffn {case} drops: {r}")
    check(ffn["cf=8.0"]["dropped_fraction"] == 0.0 and ffn["cf=0.5"]["dropped_fraction"] > 0,
          f"uncapped drops nothing, capped drops some: {ffn}")
    check(rel <= MOE_F32_LOSS_RTOL, f"tiny MoE losses, kernels against plain: {losses}")


def record_moe(L):
    """Wrap the model's ``moe_ffn`` so that each call adds an entry to
    ``calls`` as it starts and fills it with the aux dict (detached, no host
    sync) as it returns: a selective recompute may stop inside the call
    once it has what the backward needs, leaving its entry empty. Returns
    ``(calls, wrapped, inner)``."""
    calls, inner = [], L.moe_ffn

    def wrapped(*args, **kw):
        entry = {}
        calls.append(entry)
        out, aux = inner(*args, **kw)
        entry.update({k: v.detach() for k, v in aux.items()})
        return out, aux

    return calls, wrapped, inner


def moe_device_split(torch, step, state, batch, cfg) -> dict:
    """One profiled step's device ms in four groups: the flash kernels (by
    kernel name), the expert GEMMs (matmuls batched over the experts), the
    dispatch/combine einsums (matmuls with the capacity or experts x
    capacity among their dims; f32) and the rest."""
    from ray_tpu_torch.ops.moe import moe_capacity

    E = cfg.moe_experts
    T = batch["tokens"].numel()
    C = moe_capacity(T, E, cfg.moe_top_k, cfg.moe_capacity_factor)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ms = dict.fromkeys(("dispatch_combine", "expert_gemms", "flash", "rest"), 0.0)
    busy, by_kernel = 0.0, {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and "#" not in e.name \
                and not getattr(e, "is_user_annotation", False):
            dur = e.time_range.elapsed_us() / 1e3
            busy += dur
            by_kernel[e.name[:90]] = by_kernel.get(e.name[:90], 0.0) + dur
            if "flash" in e.name.lower():
                ms["flash"] += dur
        elif e.device_type.name == "CPU" and e.name in MATMULS:
            shapes = [tuple(s) for s in e.input_shapes if s]
            if "bmm" in e.name and len(shapes[0]) == 3 and shapes[0][0] == E:
                group = "expert_gemms"
            elif any(C in s or E * C in s for s in shapes):
                group = "dispatch_combine"
            else:
                continue
            ms[group] += sum(k.duration for k in e.kernels) / 1e3
    ms["rest"] = busy - ms["flash"] - ms["expert_gemms"] - ms["dispatch_combine"]
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:12]
    return {"device_ms": ms, "device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": 1 - busy / wall_ms, "capacity": C, "tokens": T,
            "top_kernels_ms": dict(top)}


def moe_7b(torch, A, L, smi, slice_summary):
    """(b) the 8-expert Llama at 7B width: 1 warm and 3 timed steps of the
    unsharded step under selective remat on phase ``slice``'s batch, then
    one profiled step."""
    from ray_tpu_torch.tools.profile_train_step import SLICE, slice_batch

    steps_timed = 3
    cfg = L.LlamaConfig.llama2_7b(moe_experts=MOE_EXPERTS, n_layers=MOE_LAYERS)
    batch = slice_batch(0, cfg.vocab_size)
    model = L.init_params(cfg, 0)
    state = (model, L.adamw(SLICE["lr"])(model.parameters()))
    step = L.make_train_step(cfg, remat="selective")
    calls, wrapped, inner = record_moe(L)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.moe_ffn = wrapped
    try:
        A.reset_launch_counts()  # this run starts here
        state, loss = step(state, batch)
        losses = [float(loss)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps_timed):
            state, loss = step(state, batch)
            losses.append(float(loss))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
        routes = {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS}
    finally:
        L.moe_ffn = inner
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + steps_timed
    # each step calls moe_ffn once per layer in the forward, then once per
    # layer in the selective recompute; the forward's calls are the step's
    per_step = 2 * cfg.n_layers
    check(len(calls) == steps * per_step, f"moe_ffn called {len(calls)} times in {steps} steps")
    fwd = [calls[i * per_step:i * per_step + cfg.n_layers] for i in range(steps)]
    check(all(c for f in fwd for c in f), "every forward moe_ffn call returned its aux")
    aux = [sum(float(c["aux_loss"]) for c in f) for f in fwd]
    dropped = [[float(c["dropped_fraction"]) for c in f] for f in fwd]
    split = moe_device_split(torch, step, state, batch, cfg)
    step_s = elapsed / steps_timed
    tokens = batch["tokens"].numel()
    emit({"phase": "moe", "part": "b_7b_bf16",
          "config": f"LlamaConfig.llama2_7b(moe_experts={MOE_EXPERTS}, n_layers={MOE_LAYERS})",
          "reduced": [f"n_layers 32 -> {MOE_LAYERS}"], "params": L.param_count(cfg),
          "top_k": cfg.moe_top_k, "capacity_factor": cfg.moe_capacity_factor,
          "batch": SLICE["batch"], "seq": SLICE["seq"], "dtype": "bfloat16",
          "remat": "selective", "optimizer": f"adamw(lr={SLICE['lr']})", "losses": losses,
          "aux_loss_per_step": aux, "dropped_fraction_per_step_by_layer": dropped,
          "step_ms": 1e3 * step_s, "tokens_per_s": tokens / step_s,
          "slice_step_ms": slice_summary["step_ms"], "max_memory_allocated_bytes": peak,
          "launches": launches, "launches_by_route": routes, "profiled_step": split,
          "nvidia_smi": smi})
    check(all(math.isfinite(x) for x in losses + aux), f"losses and aux finite: {losses} {aux}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    for name, n in launches.items():
        want = cfg.n_layers * steps
        check(n == want, f"moe {name} launched {n} times, expected {want}")
        check(routes[name] == {"tensor_core": want, "cuda_core": 0},
              f"moe {name} by route {routes[name]}: all must take the tensor cores")
    check(split["device_ms"]["expert_gemms"] > 0 and split["device_ms"]["dispatch_combine"] > 0,
          f"the profiled step's matmuls were attributed: {split}")
    return cfg, losses, 1e3 * step_s


def moe_rules_step(torch, L, smi, cfg, ref_losses, ref_step_ms):
    """(c) (b)'s model from the same seed under ``tp_rules`` on a world-1
    nccl mesh (DTensor params, ``moe_ffn_sharded``), 2 steps."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import tp_rules
    from ray_tpu_torch.tools.profile_train_step import SLICE, slice_batch

    mesh, rules = make_mesh(MeshSpec()), tp_rules()
    batch = slice_batch(0, cfg.vocab_size)
    model = L.shard_model(cfg, L.init_params(cfg, 0), mesh, rules)
    state = (model, L.adamw(SLICE["lr"])(model.parameters()))
    step = L.make_train_step(cfg, remat="selective", mesh=mesh, rules=rules)
    losses, ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    emit({"phase": "moe", "part": "c_tp_rules_world1",
          "config": f"LlamaConfig.llama2_7b(moe_experts={MOE_EXPERTS}, n_layers={MOE_LAYERS})",
          "mesh": "world 1, nccl", "rules": "tp", "remat": "selective", "losses": losses,
          "unsharded_losses": ref_losses[:2], "max_rel_diff": rel, "step_ms": ms,
          "unsharded_step_ms": ref_step_ms, "nvidia_smi": smi})
    check(rel <= BF16_LOSS_RTOL, f"tp-rules MoE losses {losses} vs unsharded {ref_losses[:2]}")


def phase_moe(torch, A, L, smi: str, slice_summary: dict):
    """MoE FFNs in the flagship step: (a) tiny f32, (b) 7B width, (c) the
    rule-constrained step."""
    import torch.distributed as dist

    gc_collect(torch)
    t_phase = time.perf_counter()
    moe_tiny_f32(torch, L, smi)
    gc_collect(torch)
    cfg, losses, step_ms = moe_7b(torch, A, L, smi, slice_summary)
    gc_collect(torch)
    try:
        moe_rules_step(torch, L, smi, cfg, losses, step_ms)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    gc_collect(torch)
    emit({"phase": "moe", "part": "end", "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# 13. seq_parallel


#: the ring's losses at 7B width against phase slice's: its chunk products
#: are f32 einsums where the slice's attention is the bf16 flash kernel
RING_LOSS_RTOL = 2.0 ** -6
SEQ_F32_ATOL = 1e-5


def seq_tiny_f32(torch, mesh, smi):
    """(a) ring and Ulysses on one rank in f32 (GQA, 4 q heads over 2 kv
    heads): outputs and q/k/v gradients against ``reference_attention``."""
    from ray_tpu_torch.ops.attention import reference_attention
    from ray_tpu_torch.ops.ring_attention import ring_attention_sharded, ulysses_attention_sharded

    b, h, hk, s, d = 2, 4, 2, 128, 16
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((b, n, s, d), generator=g, device="cuda") for n in (h, hk, hk))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        (o ** 2).mean().backward()
        return [o.detach()] + [t.grad for t in leaves]

    rep = h // hk
    ref = run(lambda q, k, v: reference_attention(q, k.repeat_interleave(rep, 1),
                                                  v.repeat_interleave(rep, 1), causal=True))
    errs = {}
    for name, fn in (("ring", lambda q, k, v: ring_attention_sharded(q, k, v, mesh,
                                                                     kv_repeat=rep)),
                     ("ulysses", lambda q, k, v: ulysses_attention_sharded(q, k, v, mesh))):
        got = run(fn)
        errs[name] = {w: float((a - r).abs().max()) for w, a, r in zip(("o", "dq", "dk", "dv"),
                                                                     got, ref)}
    emit({"phase": "seq_parallel", "part": "a_tiny_f32", "shape": [b, h, hk, s, d],
          "mesh": "world 1, nccl", "max_abs_err": errs, "tol": SEQ_F32_ATOL, "nvidia_smi": smi})
    for name, e in errs.items():
        check(max(e.values()) <= SEQ_F32_ATOL, f"{name} against the reference: {e}")


def phase_seq_parallel(torch, A, L, smi: str, slice_summary: dict):
    """Sequence-parallel attention on a world-1 nccl mesh: (a) tiny f32,
    (b) phase ``slice``'s step with Ulysses and with the ring."""
    import dataclasses

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.tools.profile_train_step import SLICE, train_slice

    gc_collect(torch)
    t_phase = time.perf_counter()
    try:
        mesh = make_mesh(MeshSpec())
        seq_tiny_f32(torch, mesh, smi)
        rows = {}
        for impl in ("ulysses", "ring"):
            cfg, state, _, batch = train_slice(seed=0)
            cfg = dataclasses.replace(cfg, attention_impl=impl)
            step = L.make_train_step(cfg, remat="selective", mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()  # this impl's steps start here
            losses, ms = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                losses.append(float(loss))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            rows[impl] = {"losses": losses, "step_ms": ms,
                          "launches": {fn.__name__: fn.launches for fn in A.KERNELS},
                          "launches_by_route": {fn.__name__: dict(fn.route_launches)
                                                for fn in A.KERNELS},
                          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
            del state, step
            gc_collect(torch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ref = slice_summary["losses"][:2]
    for r in rows.values():
        r["max_rel_diff_vs_slice"] = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
    n_layers = SLICE["n_layers"]
    emit({"phase": "seq_parallel", "part": "b_7b_bf16",
          "config": f"LlamaConfig.llama2_7b(n_layers={n_layers}) bf16",
          "reduced": [f"n_layers 32 -> {n_layers}", "seq axis of size 1 (one card)"],
          "mesh": "world 1, nccl, no rules", "remat": "selective", "impls": rows,
          "slice_losses": ref, "slice_step_ms": slice_summary["step_ms"],
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    uly, ring = rows["ulysses"], rows["ring"]
    check(uly["max_rel_diff_vs_slice"] <= BF16_LOSS_RTOL,
          f"Ulysses losses {uly['losses']} vs the slice's {ref}")
    check(ring["max_rel_diff_vs_slice"] <= RING_LOSS_RTOL,
          f"ring losses {ring['losses']} vs the slice's {ref}")
    want = 2 * n_layers
    for name in uly["launches"]:
        check(uly["launches"][name] == want, f"Ulysses {name} launched {uly['launches'][name]}")
        check(uly["launches_by_route"][name] == {"tensor_core": want, "cuda_core": 0},
              f"Ulysses {name} by route {uly['launches_by_route'][name]}")
        check(ring["launches"][name] == 0, f"the ring launched {name}: {ring['launches']}")


# ---------------------------------------------------------------------------
# 14. rl


#: the CNN's batch of frames (bench.py's cnn_forward_images_per_s shape)
#: and Atari's 6 actions; CartPole's obs and actions for the MLP nets
RL_FRAMES, RL_ACTIONS, RL_OBS_DIM, RL_MLP_ACTIONS = (256, 84, 84, 4), 6, 4, 2
#: the card's f32 forward (TF32 off) against the same function in f64 on
#: the CPU: max |err| over max |ref| (the CPU's own f32 forward is reported
#: beside it, held to nothing: it is the host library's rounding, not the
#: card's); the bf16 params' (bf16 frames) against f32: relative RMS
RL_F32_REL, RL_BF16_REL_RMS = 1e-5, 2.0 ** -6
#: one update on the card against the same update on the CPU from the
#: card's state: stats relative, params absolute as a fraction of lr (the
#: bounds of tests/test_torch_rl.py against the JAX package)
RL_STATS_RTOL, RL_PARAMS_LR_FRACTION = 1e-4, 0.05
#: the learner gang on the card against this process's card run
RL_GANG_RTOL = 1e-6


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def rel_rms(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def cnn_work(params, frames_shape, frame_bytes: int, param_bytes: int) -> tuple:
    """The Q-net forward's matmul FLOPs (convs at their SAME output sizes,
    the dense layer and the head) and bytes (frames and params read once,
    q-values written once) for one batch; and its param count."""
    from ray_tpu_torch.rl.models import DEFAULT_CONV, tree_leaves

    n, h, w, _c = frames_shape
    macs = 0
    for layer, (_ch, _k, s) in zip(params["conv"], DEFAULT_CONV):
        h, w = -(-h // s), -(-w // s)
        k, _, cin, cout = layer["w"].shape
        macs += h * w * cout * k * k * cin
    macs += sum(params[name]["w"].numel() for name in ("dense", "q"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    nbytes = (math.prod(frames_shape) * frame_bytes + n_params * param_bytes
              + n * params["q"]["w"].shape[1] * param_bytes)
    return 2 * macs * n, nbytes, n_params


def rl_forward(torch, K, smi):
    """(a) the CNN Q-net and policy and the MLP nets on the card (f32)
    against the same functions in f64 on the CPU, bf16 params against f32,
    and the Q-net's images/s beside the bound."""
    from ray_tpu_torch.rl import models as M

    g = torch.Generator().manual_seed(3)
    qnet = M.init_cnn(g, RL_FRAMES[1:], RL_ACTIONS)
    pnet = M.init_cnn(g, RL_FRAMES[1:], RL_ACTIONS, heads=("pi", "vf"))
    mlp_pi = M.init_mlp_policy(g, RL_OBS_DIM, RL_MLP_ACTIONS)
    mlp_q = M.init_mlp_q(g, RL_OBS_DIM, RL_MLP_ACTIONS)
    frames = torch.randint(0, 256, RL_FRAMES, generator=torch.Generator().manual_seed(4),
                           dtype=torch.uint8)
    obs = torch.randn((RL_FRAMES[0], RL_OBS_DIM), generator=torch.Generator().manual_seed(5))
    card = lambda tree, dtype=None: M.tree_map(lambda t: t.to("cuda", dtype), tree)
    f64 = lambda tree: M.tree_map(lambda t: t.double(), tree)
    errs, cpu_errs = {}, {}
    with torch.no_grad():
        for name, fn, params, x in (("cnn_q", M.apply_cnn_q, qnet, frames),
                                    ("cnn_policy", M.apply_cnn_policy, pnet, frames),
                                    ("mlp_policy", M.apply_mlp_policy, mlp_pi, obs),
                                    ("mlp_q", M.apply_mlp_q, mlp_q, obs)):
            x64 = x if x.dtype == torch.uint8 else x.double()
            ref, cpu32, got = fn(f64(params), x64), fn(params, x), fn(card(params), x.cuda())
            for i, (r, c, o) in enumerate(zip(*((t,) if torch.is_tensor(t) else t
                                                for t in (ref, cpu32, got)))):
                check(o.is_cuda and o.dtype == torch.float32 and o.shape == r.shape
                      and bool(torch.isfinite(o).all()),
                      f"{name} output {i} on the card, f32, finite, of shape {tuple(r.shape)}")
                errs[f"{name}/{i}"] = rel_err(o.cpu(), r)
                cpu_errs[f"{name}/{i}"] = {"cpu_f32_vs_f64": rel_err(c, r),
                                           "card_vs_cpu_f32": rel_err(o.cpu(), c)}
        q_dev, frames_dev = card(qnet), frames.cuda()
        q32 = M.apply_cnn_q(q_dev, frames_dev)
        q_bf = card(qnet, torch.bfloat16)
        frames_bf = (frames_dev.float() / 255.0).to(torch.bfloat16)  # bench.py's bf16 frames
        bf_rms = rel_rms(M.apply_cnn_q(q_bf, frames_bf), q32)
        times = {"float32": K.time_ms(lambda: M.apply_cnn_q(q_dev, frames_dev)),
                 "bfloat16": K.time_ms(lambda: M.apply_cnn_q(q_bf, frames_bf))}
    n = RL_FRAMES[0]
    rows = {}
    for dtype, ms in times.items():
        esz = 4 if dtype == "float32" else 2
        flops, nbytes, n_params = cnn_work(qnet, RL_FRAMES, 1 if esz == 4 else 2, esz)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
        bound = 1e3 * max(t_ops, t_bytes)
        rows[dtype] = {"ms": ms, "images_per_s": n / ms * 1e3, "bound_ms": bound,
                       "bound_images_per_s": n / bound * 1e3,
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "flops": flops, "bytes": nbytes,
                       "frames": "uint8" if esz == 4 else "bfloat16 (uint8 / 255)"}
    emit({"phase": "rl", "part": "a_forward", "frames": list(RL_FRAMES), "actions": RL_ACTIONS,
          "cnn_params": n_params, "max_rel_err_vs_f64": errs, "tol": RL_F32_REL,
          "reported_only": cpu_errs,
          "host_cpu": {"capability": torch.backends.cpu.get_cpu_capability(),
                       "threads": torch.get_num_threads()},
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32},
          "bf16_rel_rms_vs_f32": bf_rms, "bf16_tol": RL_BF16_REL_RMS, "cnn_q": rows,
          "nvidia_smi": smi})
    for k, e in errs.items():
        check(e <= RL_F32_REL, f"{k}: card against f64 {e} > {RL_F32_REL} ({cpu_errs[k]})")
    check(bf_rms <= RL_BF16_REL_RMS, f"bf16 CNN against f32: {bf_rms}")


def lockstep(torch, card, cpu, state_of, step, batches, lr):
    """Each batch's update on the card learner, which runs on its own, and
    on the CPU learner, put at the card's state before every update (Adam
    turns rounding-level gradient differences on near-zero gradients into
    steps apart by percents of lr, which compound: each update is held on
    its own). Returns the card's stats, each update's ms and the worst
    stats and params differences."""
    from ray_tpu_torch.rl.models import tree_leaves
    from ray_tpu_torch.rl.utils import load_state_, state_to_host

    stats, ms, worst_stat, worst_param = [], [], 0.0, 0.0
    for b in batches:
        load_state_(state_of(cpu), state_to_host(state_of(card)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = step(card, b)  # floats: waits for the update
        ms.append(1e3 * (time.perf_counter() - t0))
        ref = step(cpu, b)
        check(sorted(s) == sorted(ref) and all(math.isfinite(v) for v in s.values()),
              f"card stats {s} finite, with the CPU's keys {sorted(ref)}")
        worst_stat = max([worst_stat] + [abs(s[k] - ref[k]) / abs(ref[k]) for k in s])
        pairs = zip(tree_leaves(state_of(card)[0]), tree_leaves(state_of(cpu)[0]))
        worst_param = max([worst_param] + [float((a.detach().cpu() - b_.detach()).abs().max())
                                            for a, b_ in pairs])
        stats.append(s)
    return stats, ms, {"stats_max_rel_diff": worst_stat, "params_max_abs_diff_over_lr":
                       worst_param / lr}


def rl_learner(torch, params_cpu, device, lr, **fields):
    """A learner's state on ``device`` from the same CPU params (the
    algorithms' own ``on_device`` and ``adam``), with ``fields`` beside."""
    import types

    from ray_tpu_torch.rl.utils import adam, on_device

    params = on_device(params_cpu, device)
    return types.SimpleNamespace(device=torch.device(device), params=params,
                                 optimizer=adam(params, lr), **fields)


def rl_learners(torch, smi):
    """(b) the DQN (CNN at 84x84x4), PPO and IMPALA updates on the card,
    each held update by update against the CPU. Returns IMPALA's config,
    batches and card stats for (c)."""
    import types

    import numpy as np

    from ray_tpu_torch.rl import dqn as D
    from ray_tpu_torch.rl import impala as I
    from ray_tpu_torch.rl import models as M
    from ray_tpu_torch.rl import ppo as P
    from ray_tpu_torch.rl import utils as U
    from ray_tpu_torch.rl.replay import ReplayBuffer
    from ray_tpu_torch.rl.utils import clone_params

    rs = np.random.RandomState(6)
    out = {}
    # DQN: DQNConfig's defaults (train_batch_size 64, 32 updates an
    # iteration), a target sync every 16 updates so one falls inside the run
    dcfg = D.DQNConfig(model="cnn_q", target_update_freq=16)
    buf = ReplayBuffer(dcfg.buffer_capacity, seed=dcfg.seed)
    n = 1024
    buf.add_batch({"obs": rs.randint(0, 256, (n, *RL_FRAMES[1:])).astype(np.uint8),
                   "actions": rs.randint(0, RL_ACTIONS, n).astype(np.int64),
                   "rewards": rs.randn(n).astype(np.float32),
                   "next_obs": rs.randint(0, 256, (n, *RL_FRAMES[1:])).astype(np.uint8),
                   "dones": rs.rand(n) < 0.1})
    batches = [buf.sample(dcfg.train_batch_size) for _ in range(dcfg.updates_per_iteration)]
    qnet = M.init_cnn(torch.Generator().manual_seed(dcfg.seed), RL_FRAMES[1:], RL_ACTIONS)

    def dqn(device):
        lrn = rl_learner(torch, qnet, device, dcfg.lr, config=dcfg, gradient_steps=0)
        lrn.target_params = clone_params(lrn.params)
        lrn._apply = types.MethodType(D.DQN._apply, lrn)
        lrn._update = D.DQN._make_update(lrn)
        return lrn

    card, cpu = dqn("cuda"), dqn("cpu")
    step = lambda lrn, b: {k: float(v) for k, v in D.DQN.learn(lrn, b).items()}
    stats, ms, diff = lockstep(torch, card, cpu, lambda l: (l.params, l.target_params,
                                                             l.optimizer), step, batches, dcfg.lr)
    syncs = card.gradient_steps // dcfg.target_update_freq
    out["dqn"] = {"model": "cnn_q 84x84x4", "updates": len(batches),
                  "batch": dcfg.train_batch_size, "target_syncs": syncs, "update_ms": ms,
                  "losses": [s["loss"] for s in stats], **diff}
    # PPO: one iteration's updates, 4 epochs over 512 rows in minibatches of 256
    pcfg = P.PPOConfig(num_epochs=4, minibatch_size=256)
    rows = 512
    rollout = (rs.randn(rows, RL_OBS_DIM).astype(np.float32),
               rs.randint(0, RL_MLP_ACTIONS, rows).astype(np.int64),
               (np.log(0.5) + 0.1 * rs.randn(rows)).astype(np.float32),
               rs.randn(rows).astype(np.float32), rs.randn(rows).astype(np.float32))
    pbatches = list(P.PPO._batches(*rollout, pcfg, iteration=0))
    pnet = M.init_mlp_policy(torch.Generator().manual_seed(pcfg.seed), RL_OBS_DIM,
                             RL_MLP_ACTIONS, pcfg.hidden)
    update = P.PPO._make_update(types.SimpleNamespace(config=pcfg))

    def ppo_step(lrn, b):
        b = {k: torch.as_tensor(v, device=lrn.device) for k, v in b.items()}
        return {k: float(v) for k, v in update(lrn.params, lrn.optimizer, b).items()}

    card, cpu = (rl_learner(torch, pnet, d, pcfg.lr) for d in ("cuda", "cpu"))
    stats, ms, diff = lockstep(torch, card, cpu, lambda l: (l.params, l.optimizer), ppo_step,
                               pbatches, pcfg.lr)
    out["ppo"] = {"updates": len(pbatches), "rows": rows, "minibatch": pcfg.minibatch_size,
                  "update_ms": ms, "losses": [s["loss"] for s in stats], **diff}
    # IMPALA: 4 V-trace updates on [8 envs, 64 steps] batches
    icfg = I.IMPALAConfig()
    B, T = 8, 64
    ibatches = [{"obs": rs.randn(B, T, RL_OBS_DIM).astype(np.float32),
                 "actions": rs.randint(0, RL_MLP_ACTIONS, (B, T)).astype(np.int32),
                 "behavior_logp": (np.log(0.5) + 0.1 * rs.randn(B, T)).astype(np.float32),
                 "rewards": rs.rand(B, T).astype(np.float32),
                 "dones": (rs.rand(B, T) < 0.05).astype(np.float32),
                 "bootstrap": rs.randn(B).astype(np.float32)} for _ in range(4)]
    init_state, vtrace_update = I._make_vtrace_update(icfg, RL_OBS_DIM, RL_MLP_ACTIONS)

    def impala(device):
        return types.SimpleNamespace(_group=None, device=torch.device(device),
                                     _state=init_state(torch.device(device)),
                                     _update=vtrace_update)

    card, cpu = impala("cuda"), impala("cpu")
    stats, ms, diff = lockstep(torch, card, cpu, lambda l: l._state, I.IMPALA.learn, ibatches,
                               icfg.lr)
    out["impala"] = {"updates": len(ibatches), "batch": [B, T], "update_ms": ms,
                     "losses": [s["loss"] for s in stats], **diff}
    # evaluation on the learner's own params: the policy's input device is
    # recorded around greedy_action's call
    seen = []
    policy = U.apply_mlp_policy
    U.apply_mlp_policy = lambda p, o: (seen.append(o.device.type), policy(p, o))[1]
    try:
        obs = rs.randn(RL_OBS_DIM).astype(np.float32)
        actions = [I.IMPALA.compute_single_action(lrn, obs) for lrn in (card, cpu)]
    finally:
        U.apply_mlp_policy = policy
    out["impala"]["evaluation"] = {"devices": seen, "actions": actions}
    emit({"phase": "rl", "part": "b_learners", "dtype": "float32 (TF32 off)",
          "cudnn_deterministic": torch.backends.cudnn.deterministic,
          "stats_rtol": RL_STATS_RTOL, "params_lr_fraction": RL_PARAMS_LR_FRACTION,
          "learners": out, "nvidia_smi": smi})
    for name, r in out.items():
        check(r["stats_max_rel_diff"] <= RL_STATS_RTOL, f"{name} stats against the CPU: {r}")
        check(r["params_max_abs_diff_over_lr"] <= RL_PARAMS_LR_FRACTION,
              f"{name} params against the CPU: {r}")
    ev = out["impala"]["evaluation"]
    check(ev["devices"] == ["cuda", "cpu"] and ev["actions"][0] == ev["actions"][1],
          f"IMPALA's single-learner evaluation on the learner's device: {ev}")
    check(out["dqn"]["target_syncs"] == 2, f"DQN target syncs: {out['dqn']['target_syncs']}")
    return icfg, ibatches, stats


def rl_gang(torch, smi, icfg, batches, card_stats):
    """(c) a one-learner ``LearnerGroup`` on the card through the port's
    runtime, leasing the GPU: IMPALA's update on (b)'s batches."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import impala as I
    from ray_tpu_torch.rl.learner_group import LearnerGroup
    from ray_tpu_torch.util.reaper import find_runtime_pids

    init_state, update = I._make_vtrace_update(icfg, RL_OBS_DIM, RL_MLP_ACTIONS)
    rt.init(num_cpus=4)
    try:
        gpus = rt.cluster_resources().get("GPU", 0)
        t0 = time.perf_counter()
        group = LearnerGroup(num_learners=1, init_fn=init_state, update_builder=lambda: update,
                             resources_per_learner={"GPU": 1})
        start_s = time.perf_counter() - t0
        try:
            held = rt.available_resources().get("GPU", 0)
            stats = [group.update(b) for b in batches]
            info = group.learner_info[0]
        finally:
            group.shutdown()
        wait_gpu_back(rt)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    diff = max(abs(s[k] - c[k]) / abs(c[k]) for s, c in zip(stats, card_stats) for k in c)
    emit({"phase": "rl", "part": "c_learner_gang", "cluster_gpus": gpus,
          "gpus_free_while_held": held, "learner": info, "learner_start_s": start_s,
          "stats": stats,
          "card_stats_here": card_stats, "max_rel_diff": diff, "tol": RL_GANG_RTOL,
          "left_after": left, "nvidia_smi": smi})
    check(gpus == 1, f"the runtime detects the card: {gpus} GPUs")
    check(held == 0, f"the learner holds the GPU: {held} free")
    check(info["device"] == "cuda" and info["cuda_visible_devices"] == "0",
          f"the learner sees its leased GPU: {info}")
    check(diff <= RL_GANG_RTOL, f"gang stats against this process's card run: {diff}")
    check(not left, f"no process of the cluster survives shutdown: {left}")


def phase_rl(torch, K, smi: str):
    """RL at Atari width: (a) forward parity and throughput, (b) the
    learners on the card against the CPU, (c) the learner gang."""
    gc_collect(torch)
    t_phase = time.perf_counter()
    rl_forward(torch, K, smi)
    # cuDNN's default backward-filter algorithms accumulate with atomics:
    # the card's conv gradients vary run to run, and where a sum cancels
    # they stray far enough (1e-3 of the leaf's largest) for Adam's step on
    # a small second moment to leave the params bound in some runs. The
    # deterministic algorithms give the card one update to hold.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        icfg, batches, card_stats = rl_learners(torch, smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rl_gang(torch, smi, icfg, batches, card_stats)
    emit({"phase": "rl", "part": "end", "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# 15. pipeline


#: the pipeline's microbatches: phase slice's batch of 2 split in 2
PIPE_MICRO = 2


def pipe_grads(torch, leaves_fn, out, cot):
    """The gradients ``out.backward(cot)`` leaves on ``leaves_fn()``'s
    tensors (each set to None first)."""
    leaves = leaves_fn()
    for t in leaves:
        t.grad = None
    out.backward(cot)
    torch.cuda.synchronize()
    return [t.grad for t in leaves]


def phase_pipeline(torch, A, L, smi: str):
    """GPipe over phase ``slice``'s config, params and batch on a world-1
    nccl mesh (the stage axis 1): all layers in the one stage, the batch as
    2 microbatches, against the layer loop."""
    import types

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
    from ray_tpu_torch.tools.profile_train_step import SLICE, train_slice

    gc_collect(torch)
    t_phase = time.perf_counter()
    cfg, (model, _opt), _, batch = train_slice(seed=0)
    n_layers = SLICE["n_layers"]
    names = list(L._layer_shapes(cfg))
    with torch.no_grad():
        x = torch.nn.functional.embedding(batch["tokens"], model.embed)
    cos, sin = L.rope_tables(cfg, x.shape[1], device="cuda")

    def layer(p, x):
        x = L._attention_block(cfg, p, x, cos, sin)
        return L._mlp_block(cfg, p, x)[0]

    def stage_fn(p, x):
        for lp in p["layers"]:
            x = layer(types.SimpleNamespace(**lp), x)
        return x

    def loop(x):
        for lp in model.layers:
            x = layer(lp, x)
        return x

    stacked = stack_stage_params([{"layers": [{k: getattr(lp, k).detach() for k in names}
                                              for lp in model.layers]}])
    stacked_leaves = [lp[k].requires_grad_() for lp in stacked["layers"] for k in names]
    model_leaves = lambda: [getattr(lp, k) for lp in model.layers for k in names]
    micro = x.reshape(PIPE_MICRO, x.shape[0] // PIPE_MICRO, *x.shape[1:])
    g = torch.Generator(device="cuda").manual_seed(9)
    cot = torch.randn(micro.shape, generator=g, device="cuda", dtype=x.dtype)
    def timed(forward, leaves_fn):
        """``forward()``'s output and gradients, with the forward's and the
        backward's ms (host clock to a sync)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = forward()
        torch.cuda.synchronize()
        fwd = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        grads = pipe_grads(torch, leaves_fn, y, cot.reshape(y.shape))
        return y.detach(), grads, fwd, 1e3 * (time.perf_counter() - t0)

    try:
        mesh = make_mesh(MeshSpec())
        pipeline = lambda: pipeline_apply(mesh, stage_fn, stacked, micro)
        first = timed(pipeline, lambda: stacked_leaves)[2:]  # cuBLAS and the group warm up
        A.reset_launch_counts()  # the pipeline's forward and backward start here
        out, pipe_g, fwd_ms, bwd_ms = timed(pipeline, lambda: stacked_leaves)
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}  # read just after
        routes = {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS}
        A.reset_launch_counts()
        pipeline()
        launches_fwd = {fn.__name__: fn.launches for fn in A.KERNELS}  # a forward alone
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # the layer loop on the same microbatches, and over the whole batch (each
    # timed on its second run)
    rows = {}
    for what, run in (("per_microbatch", lambda: torch.stack([loop(m) for m in micro])),
                      ("whole_batch", lambda: loop(x))):
        timed(run, model_leaves)
        y, grads, fwd, bwd = timed(run, model_leaves)
        rows[what] = {"forward_ms": fwd, "backward_ms": bwd,
                      "forward_rel_rms": rel_rms(out.reshape(y.shape), y.detach()),
                      "forward_equal": torch.equal(out.reshape(y.shape), y.detach()),
                      "grad_max_rel_norm_err": max(
                          float((a[0].float() - b.float()).norm() / b.float().norm())
                          for a, b in zip(pipe_g, grads))}
        del y, grads
    del pipe_g, stacked, stacked_leaves
    gc_collect(torch)
    emit({"phase": "pipeline", "config": f"LlamaConfig.llama2_7b(n_layers={n_layers}) bf16",
          "reduced": [f"n_layers 32 -> {n_layers}", "stage axis 1 (one card: each stage "
                      "shift is a copy on the one rank)"],
          "mesh": "world 1, nccl, MeshSpec(stage=1)", "stages": 1, "layers_per_stage": n_layers,
          "microbatches": [PIPE_MICRO, *micro.shape[1:]], "tol": BF16_LOSS_RTOL,
          "launches_forward": launches_fwd, "launches": launches, "launches_by_route": routes,
          "forward_ms": fwd_ms, "backward_ms": bwd_ms, "first_call_ms": first, "loop": rows,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    want = n_layers * PIPE_MICRO
    check(launches_fwd == {"flash_fwd": want, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"the pipeline's forward launches {launches_fwd}")
    for name in launches:
        check(launches[name] == want, f"pipeline {name} launched {launches[name]}, want {want}")
        check(routes[name] == {"tensor_core": want, "cuda_core": 0},
              f"pipeline {name} by route {routes[name]}")
    check(rows["per_microbatch"]["forward_equal"],
          "the pipeline's forward equals the layer loop on the same microbatches")
    check(rows["whole_batch"]["forward_rel_rms"] <= BF16_LOSS_RTOL,
          f"forward against the whole batch's loop: {rows['whole_batch']}")
    for what, r in rows.items():
        check(r["grad_max_rel_norm_err"] <= BF16_LOSS_RTOL,
              f"layer gradients against the loop's ({what}): {r}")
    return launches


# ---------------------------------------------------------------------------
# 16. tune


#: (a)'s sweep: phase slice's lr and one 100x larger, TUNE_STEPS steps a
#: trial at most, under ASHA with rungs at 1 and 2 steps (the better half
#: of the trials that reached a rung go on); 10x was a third trial until
#: the script's time needed its 23 s
TUNE_LR_FACTORS = (1, 100)
TUNE_STEPS = 4
TUNE_ASHA = dict(max_t=TUNE_STEPS, grace_period=1, reduction_factor=2)
#: (b)'s sweep over train (b)'s config: its lr and one larger
TUNE_B_LR_FACTORS = (1, 10)


def tune_slice_trial(config):
    """(a)'s function trainable, run by the trial's actor on the GPU it
    leased: phase ``slice``'s config, seed and batch at ``config["lr"]``,
    TUNE_STEPS steps, each step's loss, ms and kernel launches reported
    beside what the actor saw of the card."""
    import os

    import torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import llama as L
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.tools.profile_train_step import SLICE, slice_batch

    cfg = L.LlamaConfig.llama2_7b(n_layers=SLICE["n_layers"])
    model = L.init_params(cfg, 0)
    state = (model, L.adamw(config["lr"])(model.parameters()))
    step, batch = L.make_train_step(cfg), slice_batch(0, cfg.vocab_size)
    seen = {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device_count": torch.cuda.device_count(), "device": torch.cuda.get_device_name(0)}
    for i in range(TUNE_STEPS):
        torch.cuda.synchronize()
        A.reset_launch_counts()  # this step's launches
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss = float(loss)
        torch.cuda.synchronize()
        tune.report({"step": i, "loss": loss, "step_ms": 1e3 * (time.perf_counter() - t0),
                     "launches_by_route": {fn.__name__: dict(fn.route_launches)
                                           for fn in A.KERNELS}, **seen})


class TrialClock:
    """A Tune callback: the host time of each trial's first result and of
    its completion."""

    def setup(self, experiment_dir):
        self.start, self.first, self.done = time.perf_counter(), {}, {}

    def on_trial_result(self, trial, result):
        self.first.setdefault(trial.trial_id, time.perf_counter())

    def on_trial_complete(self, trial):
        self.done[trial.trial_id] = time.perf_counter()

    def walls(self, trials):
        """Each trial's seconds from the one before it completing (or the
        sweep's start) to its first result and to its completion: with one
        trial at a time, what a trial costs, its actor's start included."""
        out, prev = [], self.start
        for t in trials:
            out.append({"to_first_result_s": self.first.get(t.trial_id, prev) - prev,
                        "wall_s": self.done[t.trial_id] - prev})
            prev = self.done[t.trial_id]
        return out


class GpuSampler:
    """Reads the cluster's free GPUs every 10 ms in a thread while it is
    entered; ``spells()`` counts the runs of readings with the GPU held."""

    def __init__(self, rt):
        import threading

        self._rt, self._stop, self.samples = rt, threading.Event(), []
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(self._rt.available_resources().get("GPU", 0))
            time.sleep(0.01)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def spells(self) -> int:
        held = [s < 1 for s in self.samples]
        return sum(1 for i, h in enumerate(held) if h and (i == 0 or not held[i - 1]))


def asha_replay(trials, mode):
    """The statuses ASHA's rule gives the trials' reported losses, fed to a
    fresh scheduler in the order the sweep ran them (one at a time): a
    trial stops at its first STOP, later reports of the same poll unfed."""
    from ray_tpu_torch.tune import ASHAScheduler
    from ray_tpu_torch.tune.schedulers import STOP

    asha, out = ASHAScheduler(mode=mode, **TUNE_ASHA), {}
    for t in trials:
        out[t.trial_id] = "TERMINATED"
        for it, m in enumerate(t.metrics_history, 1):
            if asha.on_result(t.trial_id, it, m["loss"]) == STOP:
                out[t.trial_id] = "STOPPED"
                break
    return out


def tune_function_sweep(torch, smi, slice_summary):
    """(a) a function trainable over the slice, one GPU a trial, under ASHA.
    Returns each kernel's launches over every trial."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.tools.profile_train_step import SLICE
    from ray_tpu_torch.train import RunConfig

    n_layers, lrs = SLICE["n_layers"], [SLICE["lr"] * f for f in TUNE_LR_FACTORS]
    clock = TrialClock()
    with GpuSampler(rt) as gpu:
        grid = tune.Tuner(
            tune_slice_trial, param_space={"lr": tune.grid_search(lrs)},
            resources_per_trial={"CPU": 1, "GPU": 1},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        scheduler=tune.ASHAScheduler(**TUNE_ASHA),
                                        max_concurrent_trials=1),
            run_config=RunConfig(name="tune_a", callbacks=[clock])).fit()
    wait_gpu_back(rt)
    trials = list(grid)
    replay = asha_replay(trials, "min")
    walls = clock.walls(trials)
    rows = [{"lr": t.config["lr"], "status": t.status, "error": t.error,
             "asha_replay": replay[t.trial_id],
             "losses": [m["loss"] for m in t.metrics_history],
             "step_ms": [m["step_ms"] for m in t.metrics_history],
             "seen": {k: t.metrics_history[0][k] for k in
                      ("pid", "cuda_visible_devices", "device_count", "device")}
             if t.metrics_history else None, **w} for t, w in zip(trials, walls)]
    launches = {name: sum(m["launches_by_route"][name]["tensor_core"]
                          + m["launches_by_route"][name]["cuda_core"]
                          for t in trials for m in t.metrics_history)
                for name in SOURCES}
    ref = slice_summary["losses"]
    at_slice = rows[0]["losses"]
    rel = max((abs(a - b) / abs(b) for a, b in zip(at_slice, ref)), default=math.inf)
    emit({"phase": "tune", "part": "a_function_trainable",
          "config": f"LlamaConfig.llama2_7b(n_layers={n_layers}) bf16, phase slice's seed and "
                    "batch", "reduced": [f"n_layers 32 -> {n_layers}"],
          "resources_per_trial": {"CPU": 1, "GPU": 1}, "asha": TUNE_ASHA, "trials": rows,
          "slice_losses": ref, "max_rel_diff_vs_slice": rel, "gpu_held_spells": gpu.spells(),
          "gpu_samples": len(gpu.samples), "launches": launches, "nvidia_smi": smi})
    check(all(t.status in ("TERMINATED", "STOPPED") for t in trials),
          f"every trial ran: {[(r['lr'], r['status'], r['error']) for r in rows]}")
    check(len({r["seen"]["pid"] for r in rows}) == len(lrs), "one actor a trial")
    for r in rows:
        check(r["status"] == r["asha_replay"], f"ASHA's stop follows its rule: {r}")
        check(r["seen"]["cuda_visible_devices"] == "0" and r["seen"]["device_count"] == 1
              and r["seen"]["device"] == torch.cuda.get_device_name(0),
              f"the trial's actor sees the card through its lease: {r['seen']}")
    for t in trials:
        for m in t.metrics_history:
            for name, routes in m["launches_by_route"].items():
                check(routes == {"tensor_core": n_layers, "cuda_core": 0},
                      f"tune (a) {name} launches in a step: {routes}")
    check(rows[0]["status"] == "TERMINATED" and len(at_slice) == TUNE_STEPS
          and rel <= BF16_LOSS_RTOL,
          f"the trial at the slice's lr repeats its losses: {at_slice} vs {ref}")
    check(gpu.spells() == len(lrs), f"the GPU came back between trials: {gpu.spells()} spells")
    return launches


def tune_trainer_sweep(torch, smi, storage, losses_b):
    """(b) ``TorchTrainer`` over ``llama_train_loop`` at train (b)'s config
    as the trainable, one GPU worker a trial. Returns each kernel's
    launches over every trial."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch import tune
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.tools.profile_train_step import SLICE
    from ray_tpu_torch.tools.train_llama import llama_train_loop
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchBackendConfig, TorchTrainer

    n_layers, steps = SLICE["n_layers"], len(losses_b)
    lrs = [SLICE["lr"] * f for f in TUNE_B_LR_FACTORS]
    trainer = TorchTrainer(
        llama_train_loop, train_loop_config=slice_loop(SLICE["lr"]),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        backend_config=TorchBackendConfig(mesh_spec=MeshSpec(fsdp=-1), sharding="fsdp"),
        run_config=RunConfig(name="tune_b", storage_path=storage),
        datasets={"train": rd.from_numpy(slice_rows(torch, steps), block_size=SLICE["batch"])})
    clock = TrialClock()
    with GpuSampler(rt) as gpu:
        grid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search(lrs)},
            tune_config=tune.TuneConfig(metric="final_loss", mode="min",
                                        max_concurrent_trials=1),
            run_config=RunConfig(name="tune_b_sweep", callbacks=[clock])).fit()
    wait_gpu_back(rt)
    trials = list(grid)
    walls = clock.walls(trials)
    rows = [{"lr": t.config["lr"], "status": t.status, "error": t.error,
             "losses": t.metrics.get("losses"), "step_ms": t.metrics.get("step_ms_each"),
             **{k: t.metrics.get(k) for k in ("cuda_visible_devices", "device_count",
                                              "backend", "world_size", "launches_by_route")},
             **w} for t, w in zip(trials, walls)]
    launches = {name: sum(t.metrics["launches"][name] for t in trials) for name in SOURCES}
    best = grid.get_best_result()
    rel = max((abs(a - b) / abs(b) for a, b in zip(rows[0]["losses"] or [], losses_b)),
              default=math.inf)
    emit({"phase": "tune", "part": "b_trainer_trainable",
          "config": f"LlamaConfig.llama2_7b(n_layers={n_layers}) bf16 through TorchTrainer "
                    "(nccl world 1, fsdp rules, selective remat)",
          "reduced": [f"n_layers 32 -> {n_layers}"], "trials": rows,
          "best_lr": best.config["lr"], "train_b_losses": losses_b, "max_rel_diff_vs_train_b": rel,
          "gpu_held_spells": gpu.spells(), "launches": launches, "nvidia_smi": smi})
    for t in trials:
        check(t.status == "TERMINATED", f"trial lr={t.config['lr']}: {t.status} {t.error}")
        train_worker_checks(t.metrics, f"tune (b) lr={t.config['lr']}")
        for name, routes in t.metrics["launches_by_route"].items():
            want = n_layers * steps
            check(routes == {"tensor_core": want, "cuda_core": 0},
                  f"tune (b) {name} launches by route: {routes}")
    check(best.metrics["final_loss"] == min(t.metrics["final_loss"] for t in trials),
          f"the best trial has the lowest final loss: {[r['losses'] for r in rows]}")
    check(len(rows[0]["losses"]) == steps and rel <= BF16_LOSS_RTOL,
          f"the trial at train (b)'s lr repeats its losses: {rows[0]['losses']} vs {losses_b}")
    check(gpu.spells() == len(lrs), f"the GPU came back between trials: {gpu.spells()} spells")
    return launches


def phase_tune(torch, smi: str, slice_summary: dict, losses_b):
    """Tune sweeps on the port's cluster on the card: (a) a function
    trainable over the slice, (b) ``TorchTrainer`` as the trainable.
    Returns each kernel's launches in both."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc_collect(torch)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tune_runs_") as storage:
        try:
            rt.init(num_cpus=4)
            check(rt.cluster_resources().get("GPU") == 1, "the runtime detects the card")
            a = tune_function_sweep(torch, smi, slice_summary)
            b = tune_trainer_sweep(torch, smi, storage, losses_b)
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "tune", "part": "end", "left_after": left,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    check(not left, f"no process of the cluster survives shutdown: {left}")
    return {name: a[name] + b[name] for name in SOURCES}


# ---------------------------------------------------------------------------
# 17. job


#: (i)'s training job: phase slice's model, batch and lr through the
#: trainer; (ii)'s job to stop: the tiny model in f32 for many steps
JOB_STEPS, JOB_STOP_STEPS = 2, 500


def job_entrypoint(config, rows_path, name, storage) -> str:
    import shlex

    return (f"{shlex.quote(sys.executable)} -m ray_tpu_torch.tools.train_llama "
            f"--name {name} --storage {shlex.quote(storage)} --rows {shlex.quote(rows_path)} "
            f"--config {shlex.quote(json.dumps(config))}")


def job_lines(logs: str):
    """The JSON lines ``tools/train_llama.py`` printed."""
    return [json.loads(line) for line in logs.splitlines() if line.startswith("{")]


def gang_pids():
    """Pids of the live ``TrainWorker`` actors (a training gang)."""
    from ray_tpu_torch.util import state

    return [a["pid"] for a in state.list_actors()
            if a["class_name"].startswith("TrainWorker") and a["state"] == "ALIVE"]


def job_train(torch, client, smi, storage, slice_summary):
    """(i) a job that trains phase slice's model JOB_STEPS steps through
    ``TorchTrainer`` on the cluster it was given. Returns each kernel's
    launches in the job's worker."""
    import numpy as np

    from ray_tpu_torch.tools.profile_train_step import SLICE

    rows_path = f"{storage}/job_rows.npy"
    np.save(rows_path, slice_rows(torch, JOB_STEPS))
    t0 = time.perf_counter()
    job_id = client.submit_job(
        entrypoint=job_entrypoint(slice_loop(SLICE["lr"]), rows_path, "job_i", storage))
    chunks = list(client.tail_job_logs(job_id, poll_s=0.2))
    wall_s = time.perf_counter() - t0
    status, logs = client.get_job_status(job_id), "".join(chunks)
    lines = job_lines(logs) if status == "SUCCEEDED" else []
    entry = lines[0]["entrypoint"] if lines else None
    losses = [m["loss"] for m in lines[1:] if "loss" in m]
    done = lines[-1] if lines else {}
    ref = slice_summary["losses"][:JOB_STEPS]
    rel = max((abs(a - b) / abs(b) for a, b in zip(losses, ref)), default=math.inf)
    want = SLICE["n_layers"] * JOB_STEPS
    emit({"phase": "job", "part": "i_training_job", "status": status, "chunks": len(chunks),
          "entrypoint": entry, "losses": losses, "slice_losses": ref, "max_rel_diff": rel,
          "step_ms": done.get("step_ms_each"), "worker": {
              k: done.get(k) for k in ("cuda_visible_devices", "device_count", "device_name",
                                       "backend", "world_size", "launches_by_route")},
          "submit_to_end_s": wall_s, "logs_tail": None if lines else logs[-4000:],
          "nvidia_smi": smi})
    check(status == "SUCCEEDED", f"the training job succeeded: {status}")
    check(entry["cuda_visible_devices"] == "", f"the entrypoint sees no card: {entry}")
    check(len(losses) == JOB_STEPS and rel <= BF16_LOSS_RTOL,
          f"the job's losses {losses} against the slice's {ref}")
    train_worker_checks(done, "job (i)")
    check(done["device_name"] == torch.cuda.get_device_name(0), "the worker's device is the card")
    for name, routes in done["launches_by_route"].items():
        check(routes == {"tensor_core": want, "cuda_core": 0}, f"job {name} by route: {routes}")
    return {name: done["launches"][name] for name in SOURCES}


def job_stop(rt, client, smi, storage):
    """(ii) ``stop_job`` on a job while its trainer's worker holds the GPU."""
    import numpy as np

    rows_path = f"{storage}/job_stop_rows.npy"
    np.save(rows_path, np.random.RandomState(5).randint(0, 256, size=(JOB_STOP_STEPS * 2, 65)))
    config = {"model": {"preset": "tiny", "dtype": "float32"}, "seed": 0, "lr": 1e-3,
              "remat": False, "batch_size": 2}
    job_id = client.submit_job(entrypoint=job_entrypoint(config, rows_path, "job_ii", storage))
    deadline = time.monotonic() + 120
    while not gang_pids() or rt.available_resources().get("GPU", 0) != 0:
        check(time.monotonic() < deadline and client.get_job_status(job_id) in (
            "PENDING", "RUNNING"), f"the job's worker holds the GPU: {client.get_job_logs(job_id)}")
        time.sleep(0.1)
    gang = gang_pids()
    entry = job_lines(client.get_job_logs(job_id))[0]["entrypoint"]
    t0 = time.perf_counter()
    stopped = client.stop_job(job_id)
    status = client.wait_until_terminal(job_id, timeout=60)
    try:
        wait_gpu_back(rt, 30.0)
    except RuntimeError:
        from ray_tpu_torch.util import state

        # what still holds the GPU
        emit({"phase": "job", "part": "ii_gpu_held", "job": client.get_job_info(job_id),
              "entrypoint_alive": bool(process_maps(entry["pid"])),
              "gang_alive": [bool(process_maps(p)) for p in gang],
              "actors": [{k: a.get(k) for k in ("class_name", "state", "pid")}
                         for a in state.list_actors() if a["state"] != "DEAD"],
              "placement_groups": state.list_placement_groups(),
              "logs_tail": client.get_job_logs(job_id)[-2000:]})
        raise
    back_s = time.perf_counter() - t0
    left = [p for p in [entry["pid"], *gang] if not rt_pid_gone(p)]
    emit({"phase": "job", "part": "ii_stop", "stopped": stopped, "status": status,
          "entrypoint_pid": entry["pid"], "gang_pids": gang, "left": left,
          "stop_to_gpu_back_s": back_s, "nvidia_smi": smi})
    check(stopped and status == "STOPPED", f"stop_job gives STOPPED: {stopped} {status}")
    check(not left, f"no process of the job survives: {left}")


def phase_job(torch, smi: str, slice_summary: dict):
    """Jobs on the port's cluster on the card, through the job server's
    REST API: (i) a training job, (ii) a job stopped while it holds the
    GPU. Returns each kernel's launches in (i)."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.job import JobSubmissionClient, start_job_server, stop_job_server
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc_collect(torch)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="job_runs_") as storage:
        try:
            rt.init(num_cpus=4)
            server = start_job_server(port=0)
            try:
                client = JobSubmissionClient(f"http://127.0.0.1:{server.port}")
                launches = job_train(torch, client, smi, storage, slice_summary)
                job_stop(rt, client, smi, storage)
            finally:
                stop_job_server()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "job", "part": "end", "left_after": left,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    check(not left, f"no process of the cluster survives shutdown: {left}")
    return launches


# ---------------------------------------------------------------------------
# 18. autoscaler


#: the autoscaled node's idle timeout and the autoscaler's period
AS_IDLE_S, AS_PERIOD_S = 3.0, 0.3


def as_kernels_in_worker(case, seed):
    """``rt_kernels_in_worker`` on the autoscaled node, stamped with the
    wall time it started (the driver and the node share one host clock)."""
    started = time.time()
    report, _o = rt_kernels_in_worker(case, seed)
    return {**report, "started_at": started}


def phase_autoscaler(torch, K, smi: str):
    """A GPU node launched by the autoscaler for a pending ``num_gpus=1``
    task on a GPU-less head, and terminated once idle. Returns each
    kernel's launches in the task."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (
        AutoscalerConfig, FakeMultiNodeProvider, NodeTypeConfig, StandardAutoscaler)
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc_collect(torch)
    t_phase = time.perf_counter()
    cluster = Cluster(head_resources={"GPU": 0}, num_cpus=2)  # no detection: a GPU-less head
    controller = f"127.0.0.1:{cluster.controller_port}"
    provider = FakeMultiNodeProvider(controller)
    node_type = NodeTypeConfig("h100", {"CPU": 1, "GPU": 1}, max_workers=1)
    try:
        rt.init(address=cluster.address)
        head_gpus = rt.cluster_resources().get("GPU", 0)
        autoscaler = StandardAutoscaler(provider, AutoscalerConfig(
            node_types=[node_type], idle_timeout_s=AS_IDLE_S, update_interval_s=AS_PERIOD_S))
        autoscaler.start()
        try:
            t_demand = time.time()
            report = rt.get(rt.remote(num_gpus=1)(as_kernels_in_worker).remote(K.MAIN, 0),
                            timeout=300)
            t_idle = time.perf_counter()  # the task is done: the node goes idle
            nodes = provider.non_terminated_nodes()
            daemons = [provider._nodes[n["id"]]["proc"].pid for n in nodes]
            deadline = time.monotonic() + 120
            while provider.non_terminated_nodes():
                check(time.monotonic() < deadline, "the idle node is terminated")
                time.sleep(0.05)
            idle_to_gone_s = time.perf_counter() - t_idle
            left = [p for p in [*daemons, report["pid"]] if not rt_pid_gone(p)]
        finally:
            autoscaler.stop()
    finally:
        try:
            provider.shutdown()
        finally:
            rt.shutdown()
            cluster.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(controller_addr=controller) and time.monotonic() < deadline:
        time.sleep(0.1)
    cluster_left = find_runtime_pids(controller_addr=controller)
    emit({"phase": "autoscaler", "part": "gpu_node", "head_gpus": head_gpus,
          "node_type": {"name": node_type.name, "resources": node_type.resources},
          "idle_timeout_s": AS_IDLE_S, "nodes_launched": nodes, "task": report,
          "demand_to_task_start_s": report["started_at"] - t_demand,
          "idle_to_terminated_s": idle_to_gone_s, "left": left, "cluster_left": cluster_left,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    check(head_gpus == 0, f"the head has no GPU: {head_gpus}")
    check([n["node_type"] for n in nodes] == ["h100"], f"one h100 node launched: {nodes}")
    check(report["cuda_visible_devices"] == "0" and report["device_count"] == 1
          and report["device"] == torch.cuda.get_device_name(0),
          f"the task sees the card through the node's GPU 0: {report}")
    for name, routes in report["launches_by_route"].items():
        check(routes == {"tensor_core": 1, "cuda_core": 0}, f"autoscaler {name}: {routes}")
    for what, r in report["readings"].items():
        check(r["ok"], f"autoscaled worker {what}: {r}")
    check(not left, f"the node's daemon and worker are gone: {left}")
    check(not cluster_left, f"no process of the cluster survives: {cluster_left}")
    return report["launches"]


# ---------------------------------------------------------------------------
# 19. cli


def phase_cli(torch, K, smi: str):
    """The operator CLI on the card: ``start --head``, ``status``, ``list
    nodes``, a driver's ``num_gpus=1`` task, ``stop``."""
    import os
    import re
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc_collect(torch)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        env = dict(os.environ, TMPDIR=tmp)  # the CLI's PID files: a directory of its own

        def cli(*args):
            out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts", *args],
                                 capture_output=True, text=True, env=env, timeout=120)
            check(out.returncode == 0, f"cli {args}: {out.stderr[-2000:]}")
            return out.stdout

        started = cli("start", "--head", "--num-cpus", "2")
        addr = re.search(r"address: (\S+)", started).group(1)
        head_pid = int(re.search(r"pid (\d+)", started).group(1))
        stopped, report = None, None
        try:
            status = cli("status", "--address", addr)
            nodes = json.loads(cli("list", "nodes", "--address", addr))
            rt.init(address=addr)
            try:
                task = rt.remote(num_gpus=1)(rt_kernels_in_worker)
                report, _o = rt.get(task.remote(K.MAIN, 0), timeout=300)
                del _o
            finally:
                rt.shutdown()
        finally:
            stopped = cli("stop")
        controller = ":".join(addr.split(":")[:2])
        deadline = time.monotonic() + 30
        while (find_runtime_pids() or not rt_pid_gone(head_pid, 0.1)) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        left = find_runtime_pids()
    emit({"phase": "cli", "status": status, "nodes": nodes, "task": report,
          "stop": stopped.strip(), "left": left, "controller": controller,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    check("cluster: 1 node(s)" in status and "GPU: 1/1 available" in status,
          f"status lists the node and its GPU: {status}")
    check(len(nodes) == 1 and nodes[0]["Resources"].get("GPU") == 1.0,
          f"list nodes shows the node with its GPU: {nodes}")
    check(report["cuda_visible_devices"] == "0" and report["readings"]["o"]["ok"]
          and report["launches_by_route"]["flash_fwd"] == {"tensor_core": 1, "cuda_core": 0},
          f"the driver's GPU task ran the forward kernel against its plain version: {report}")
    check(stopped.strip() == "stopped 1 daemon(s)", f"stop: {stopped}")
    check(not left and rt_pid_gone(head_pid, 0.1), f"no process of the port's is left: {left}")


# ---------------------------------------------------------------------------
# 20. dag


#: the pipeline's GPU stage: Llama-2-7B's width at this depth, bf16;
#: seeded prompts of DAG_PROMPT tokens, DAG_PIPELINED executions in flight
#: before the first get, then DAG_TIMED one at a time on each path
DAG_LAYERS, DAG_PROMPT, DAG_PIPELINED, DAG_TIMED = 2, 512, 16, 8
#: a logit's bound, relative to the largest of the driver's (phase slice's
#: bf16 bound); the same kernels at the same shapes are expected to give 0
DAG_REL_TOL = 2.0 ** -8


class DagLlamaStage:
    """The GPU stage, a ``num_gpus=1`` actor: the Llama made here from the
    seed (nothing 7B-sized crosses the store), returning the last
    position's logits on the card."""

    def __init__(self, seed, warm_tokens):
        import torch
        from ray_tpu_torch.models import llama as L
        from ray_tpu_torch.ops import attention as A

        t0 = time.perf_counter()
        self.cfg = L.LlamaConfig.llama2_7b(n_layers=DAG_LAYERS)
        self.params = L.init_params(self.cfg, seed, device="cuda")
        self.forward(warm_tokens)  # cuBLAS and the kernel library load here, not in a run
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0
        self.produced = None
        A.reset_launch_counts()

    def forward(self, tokens):
        import torch
        from ray_tpu_torch.models import llama as L

        with torch.no_grad():
            t = torch.as_tensor(tokens, device="cuda")
            out = L.forward(self.cfg, self.params, t)[:, -1].contiguous()
        self.out_device = str(out.device)
        return out

    def forward_device(self, tokens):
        """``forward`` for a same-actor consumer; remembers its output."""
        self.produced = self.forward(tokens)
        return self.produced

    def pick_on_card(self, logits):
        """The consumer of ``forward_device``: the token, and whether the
        value came by reference (the producer's CUDA tensor itself)."""
        import torch

        return {"token": int(torch.argmax(logits, dim=-1)[0]), "is_cuda": logits.is_cuda,
                "same_tensor": logits is self.produced,
                "same_data_ptr": logits.data_ptr() == self.produced.data_ptr()}

    def reset_counts(self):
        from ray_tpu_torch.ops import attention as A

        A.reset_launch_counts()

    def report(self):
        import os

        import torch
        from ray_tpu_torch.ops import attention as A

        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0), "init_s": self.init_s,
                "out_device": self.out_device,
                "launches": {fn.__name__: fn.launches for fn in A.KERNELS},
                "launches_by_route": {fn.__name__: dict(fn.route_launches) for fn in A.KERNELS},
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


class DagArgmaxStage:
    """The CPU stage: the token, returned with the logits it came from."""

    def __init__(self):
        import torch  # noqa: F401  (imported at start, not inside the first run)

    def pick(self, logits):
        import os

        import torch

        return {"token": int(torch.argmax(logits, dim=-1)[0]), "logits": logits,
                "device": str(logits.device),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}


def dag_pipeline(rt, gpu, cpu, prompts, refs, smi):
    """(a) the two-stage compiled pipeline, (d) its per-execution time
    beside ``.remote()`` and ``get``. Returns the stage's launch report."""
    from ray_tpu_torch.dag import InputNode

    rt.get(gpu.reset_counts.remote(), timeout=60)  # the main path's run starts here
    with InputNode() as inp:
        dag = cpu.pick.bind(gpu.forward.bind(inp))
    compiled = dag.experimental_compile(_max_inflight_executions=DAG_PIPELINED)
    try:
        t0 = time.perf_counter()
        pending = [compiled.execute(p) for p in prompts]  # all in flight before the first get
        outs = [r.get(timeout=120) for r in pending]
        pipelined_s = time.perf_counter() - t0
        compiled_ms = []
        for p in prompts[:DAG_TIMED]:
            t1 = time.perf_counter()
            compiled.execute(p).get(timeout=120)
            compiled_ms.append(1e3 * (time.perf_counter() - t1))
    finally:
        compiled.teardown()
    stage = rt.get(gpu.report.remote(), timeout=60)  # read just after
    executions = len(prompts) + DAG_TIMED

    rt.get(cpu.pick.remote(rt.get(gpu.forward.remote(prompts[0]), timeout=120)), timeout=120)
    remote_ms, remote_tokens = [], []
    for p in prompts[:DAG_TIMED]:
        t1 = time.perf_counter()
        out = rt.get(cpu.pick.remote(rt.get(gpu.forward.remote(p), timeout=120)), timeout=120)
        remote_ms.append(1e3 * (time.perf_counter() - t1))
        remote_tokens.append(out["token"])

    ref_max = max(float(r.abs().max()) for r in refs)
    tol = DAG_REL_TOL * ref_max
    diffs = [float((o["logits"].float() - r).abs().max()) for o, r in zip(outs, refs)]
    tokens = [o["token"] for o in outs]
    ref_tokens, margins = [], []
    for r in refs:
        top2 = r[0].topk(2).values
        ref_tokens.append(int(r[0].argmax()))
        margins.append(float(top2[0] - top2[1]))
    # a token can differ from the driver's only where the margin is at
    # most twice the largest difference of a logit
    decided = [i for i, m in enumerate(margins) if m > 2 * max(diffs)]
    emit({"phase": "dag", "part": "a_pipeline",
          "config": f"LlamaConfig.llama2_7b(n_layers={DAG_LAYERS})", "dtype": "bfloat16",
          "prompt": [1, DAG_PROMPT], "executions_pipelined": len(prompts),
          "executions_timed": DAG_TIMED, "pipelined_s": pipelined_s,
          "max_abs_diff": max(diffs), "tol": tol, "tokens": tokens, "ref_tokens": ref_tokens,
          "top2_margins": margins, "decided": len(decided),
          "out_shapes": sorted({tuple(o["logits"].shape) for o in outs}),
          "cpu_stage_devices": sorted({o["device"] for o in outs}),
          "cpu_stage_cuda_visible_devices": sorted({str(o["cuda_visible_devices"]) for o in outs}),
          "stage": stage, "nvidia_smi": smi})
    emit({"phase": "dag", "part": "d_overhead", "compiled_ms": compiled_ms,
          "compiled_p50_ms": quantiles(compiled_ms)["p50"], "remote_ms": remote_ms,
          "remote_p50_ms": quantiles(remote_ms)["p50"], "nvidia_smi": smi})
    check(stage["cuda_visible_devices"] == "0" and stage["out_device"] == "cuda:0",
          f"the GPU stage holds GPU 0 and leaves its logits on the card: {stage}")
    check(all(o["device"] == "cpu" and o["cuda_visible_devices"] == "" for o in outs),
          "the CPU stage gets host logits through the shm channel and sees no GPU")
    check(all(tuple(o["logits"].shape) == (1, 32000) and bool(o["logits"].isfinite().all())
              for o in outs), "the logits are finite, [1, vocab]")
    check(max(diffs) <= tol, f"the pipeline's logits against the driver's forward: {diffs}")
    check(all(tokens[i] == int(outs[i]["logits"][0].argmax()) for i in range(len(outs))),
          "the CPU stage's token is its logits' argmax")
    check(all(tokens[i] == ref_tokens[i] for i in decided),
          f"tokens equal the driver's argmax wherever the top-2 margin is decided: "
          f"{tokens} vs {ref_tokens}")
    check(remote_tokens == tokens[:DAG_TIMED], f".remote() and get give the same tokens: "
          f"{remote_tokens}")
    expect = {"tensor_core": DAG_LAYERS * executions, "cuda_core": 0}
    check(stage["launches_by_route"]["flash_fwd"] == expect,
          f"the GPU stage launched the forward kernel {DAG_LAYERS} times an execution, "
          f"on the tensor cores: {stage['launches_by_route']}")
    check(stage["launches"]["flash_bwd_dq"] == 0 and stage["launches"]["flash_bwd_dkv"] == 0,
          f"no backward kernel on the inference path: {stage['launches']}")
    return stage, tokens


def dag_device_transport(rt, gpu, cpu, prompts, tokens, smi):
    """(b) the ``"device"`` transport: a same-actor edge passes the CUDA
    tensor by reference through no channel; a cross-process one is refused
    at compile time."""
    from ray_tpu_torch.dag import InputNode

    with InputNode() as inp:
        on_card = gpu.forward_device.bind(inp).with_tensor_transport("device")
        dag = gpu.pick_on_card.bind(on_card)
    compiled = dag.experimental_compile()
    try:
        channels = len(compiled._all_chans)  # the input's and the output's
        outs = [compiled.execute(p).get(timeout=120) for p in prompts]
    finally:
        compiled.teardown()
    with InputNode() as inp:
        bad = cpu.pick.bind(gpu.forward_device.bind(inp).with_tensor_transport("device"))
    refused = None
    try:
        bad.experimental_compile().teardown()
    except ValueError as e:
        refused = str(e)
    emit({"phase": "dag", "part": "b_device_transport", "channels": channels, "outs": outs,
          "refused": refused, "nvidia_smi": smi})
    check(channels == 2, f"no shm channel for the device edge: {channels} channels")
    check(all(o["is_cuda"] and o["same_tensor"] and o["same_data_ptr"] for o in outs),
          f"the consumer gets the producer's CUDA tensor by reference: {outs}")
    check([o["token"] for o in outs] == tokens[:len(prompts)],
          "the device edge's tokens equal the pipeline's")
    check(refused is not None and "with_tensor_transport('device') but has consumers in "
          "other processes" in refused, f"a cross-process device edge is refused: {refused}")


def phase_dag(torch, L, smi: str):
    """Compiled graphs on the card: (a) a GPU stage running the Llama at
    7B width feeding a CPU stage through shm channels, (b) the device
    transport, (c) teardown, (d) per-execution time against ``.remote()``.
    Returns each kernel's launches in (a)."""
    import os

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.reaper import find_runtime_pids

    gc_collect(torch)
    t_phase = time.perf_counter()
    seed = 0
    rs = np.random.default_rng(seed)
    cfg = L.LlamaConfig.llama2_7b(n_layers=DAG_LAYERS)
    prompts = [rs.integers(0, cfg.vocab_size, (1, DAG_PROMPT), dtype=np.int64)
               for _ in range(DAG_PIPELINED)]
    try:
        rt.init(num_cpus=4)
        gpus = rt.cluster_resources().get("GPU", 0)
        check(gpus == 1, f"the runtime detects the card: {gpus} GPUs")
        t0 = time.perf_counter()
        gpu = rt.remote(num_gpus=1)(DagLlamaStage).remote(seed, prompts[0])
        cpu = rt.remote(num_cpus=1)(DagArgmaxStage).remote()
        # the driver's forward on the same seed while the stages start
        params = L.init_params(cfg, seed, device="cuda")
        with torch.no_grad():
            refs = [L.forward(cfg, params, torch.as_tensor(p, device="cuda"))[:, -1].float().cpu()
                    for p in prompts]
        del params
        gc_collect(torch)
        rt.get([gpu.reset_counts.remote(), cpu.__ray_ready__()], timeout=300)
        start_s = time.perf_counter() - t0
        stage, tokens = dag_pipeline(rt, gpu, cpu, prompts, refs, smi)
        dag_device_transport(rt, gpu, cpu, prompts[:4], tokens, smi)
        held = rt.available_resources().get("GPU", 0)
        rt.kill(gpu)
        rt.kill(cpu)
        del gpu, cpu
        wait_gpu_back(rt)
        back = rt.available_resources().get("GPU", 0)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 15
    while find_runtime_pids(spawner_pid=os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = find_runtime_pids(spawner_pid=os.getpid())
    emit({"phase": "dag", "part": "c_teardown", "actors_start_s": start_s,
          "gpus_free_while_held": held, "gpus_free_after_kill": back, "left_after": left,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
    check(held == 0, f"the GPU stage holds the GPU: {held} free")
    check(not left, f"no process of the cluster survives shutdown: {left}")
    return stage["launches"]


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
    t_start = time.perf_counter()
    launches, routes, slice_summary = phase_slice(torch, A, L, smi)
    serve_summary = phase_serve(torch, A, L, smi)
    phase_serve_llm(torch, A, L, smi)
    phase_runtime(torch, K, L, smi, serve_summary)
    sd_gap_s, ingress_launches = phase_serve_deployment(torch, A, L, smi, serve_summary)
    phase_kv_migration(torch, A, L, smi, sd_gap_s)
    losses_b = phase_train(torch, A, L, smi, slice_summary)
    phase_moe(torch, A, L, smi, slice_summary)
    phase_seq_parallel(torch, A, L, smi, slice_summary)
    phase_rl(torch, K, smi)
    pipe_launches = phase_pipeline(torch, A, L, smi)
    tune_launches = phase_tune(torch, smi, slice_summary, losses_b)
    job_launches = phase_job(torch, smi, slice_summary)
    as_launches = phase_autoscaler(torch, K, smi)
    phase_cli(torch, K, smi)
    dag_launches = phase_dag(torch, L, smi)
    emit({"phase": "total", "seconds_from_slice": time.perf_counter() - t_start,
          "seconds": time.perf_counter() - T_IMPORT})
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": TPU_KERNELS[k][1], "replaces_fn": TPU_KERNELS[k][0],
         "launches": launches[k], "max_abs_err": errs[k], **times[k],
         "launches_by_route": routes[k], "launches_pipeline": pipe_launches[k],
         "launches_tune": tune_launches[k], "launches_job": job_launches[k],
         "launches_autoscaler": as_launches[k], "launches_dag": dag_launches[k],
         "launches_ingress": ingress_launches[k]}
        for k in SOURCES
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
