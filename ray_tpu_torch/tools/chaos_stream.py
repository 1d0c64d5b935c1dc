"""One replica that streams one request and may be killed mid-stream.

``python -m ray_tpu_torch.tools.chaos_stream --request '{"prompt": [...], ...}'``
builds an ``LLMServer`` from a seed (the same weights as any other server
built from that seed on that device), sends it the request in resume mode
(``resume_from=0`` unless the request names another) and prints each
``(seq, token)`` pair as a JSON line ``[seq, token]`` on stdout, flushed as
it arrives. The seeded replica fault plan is armed through the environment
(``RAY_TPU_testing_replica_chaos`` and ``RAY_TPU_testing_replica_chaos_seed``),
as a deployment arms every replica: ``kill_mid_decode:1.0:6`` SIGKILLs the
process before its seventh decode step, so the consumer holds the tokens
printed so far and resumes the stream elsewhere behind a ``SeqGate``.

Options: ``--model tiny|llama2_7b``, ``--n-layers``, ``--dtype
float32|bfloat16``, ``--device`` (``cuda`` unless named), ``--seed`` and
``--engine`` (``EngineConfig`` fields as JSON). With ``--dtype float32``
on the card, TF32 is off. ``stream_in_child`` runs it from another
process and collects what it printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("tiny", "llama2_7b"), default="tiny")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="{}", help="EngineConfig fields as JSON")
    ap.add_argument("--request", required=True, help="the request dict as JSON")
    args = ap.parse_args(argv)

    import torch

    from ray_tpu_torch.inference import EngineConfig, LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig

    overrides = {}
    if args.n_layers is not None:
        overrides["n_layers"] = args.n_layers
    if args.dtype is not None:
        overrides["dtype"] = getattr(torch, args.dtype)
    if args.dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = getattr(LlamaConfig, args.model)(**overrides)
    server = LLMServer(cfg, EngineConfig(**json.loads(args.engine)), seed=args.seed,
                       export_metrics=False, device=args.device)
    request = {"resume_from": 0, **json.loads(args.request)}
    try:
        for chunk in server.generate(request):
            for seq, tok in chunk:
                print(json.dumps([seq, tok]), flush=True)
    finally:
        server.engine.stop()
    return 0


def stream_in_child(request, spec: str, chaos_seed: int, *, env=None, timeout: float = 600,
                    **opts):
    """Runs this module in a child process with the replica fault plan
    ``spec`` armed by ``chaos_seed`` (``opts`` are its options, ``n_layers=2``
    for ``--n-layers 2``; ``env`` adds variables). Returns the
    ``(seq, token)`` pairs the child printed, its return code (``-9``
    when SIGKILLed) and its stderr. A child still running at ``timeout``
    is killed."""
    cmd = [sys.executable, "-m", "ray_tpu_torch.tools.chaos_stream",
           "--request", json.dumps(request)]
    for key, value in opts.items():
        cmd += ["--" + key.replace("_", "-"),
                json.dumps(value) if isinstance(value, dict) else str(value)]
    root = str(Path(__file__).resolve().parents[2])
    child_env = dict(os.environ, **(env or {}), RAY_TPU_testing_replica_chaos=spec,
                     RAY_TPU_testing_replica_chaos_seed=str(chaos_seed))
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, child_env.get("PYTHONPATH")) if p)
    proc = subprocess.run(cmd, env=child_env, capture_output=True, text=True, timeout=timeout)
    pairs = [tuple(json.loads(line)) for line in proc.stdout.splitlines() if line.strip()]
    return pairs, proc.returncode, proc.stderr


if __name__ == "__main__":
    sys.exit(main())
