"""What ``chip_smoke.py`` and ``tools/multi_card_smoke.py`` share: the one
bytecode cache of the processes they start, the cards' ``nvidia-smi``
readings, quantiles, and the serving configuration's engine and traffic.

Imports nothing heavy: ``bytecode_cache`` must run before torch is
imported.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

#: the checkout's root (this file is ``ray_tpu_torch/tools/_smoke_common.py``)
ROOT = Path(__file__).resolve().parents[2]

#: the serving configuration's engine (full width and depth of Llama-2-7B)
SERVE_ENGINE = dict(block_size=16, num_blocks=640, prefill_buckets=(64, 128, 256, 512),
                    decode_buckets=(1, 2, 4, 8), max_decode_batch=8,
                    prefix_cache_enabled=True, warmup=True)
#: the traffic: SERVE_CLIENTS threads send SERVE_REQUESTS requests in all
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_NEW_TOKENS, SHARED_PREFIX = 8, 64, 32, 512


def bytecode_cache() -> None:
    """Python on the card's machine runs with ``PYTHONDONTWRITEBYTECODE=1``
    and no cached bytecode for torch, so every process a script starts
    would compile torch's modules anew as it imports them. The script's
    processes share one bytecode cache under the checkout instead
    (``_build``, which git ignores): the first process to import a module
    writes it, the others read it."""
    cache = ROOT / "ray_tpu_torch" / "_build" / "pycache"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["PYTHONPYCACHEPREFIX"] = str(cache)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = str(cache)
    sys.dont_write_bytecode = False


def nvidia_smi(*args: str) -> str:
    """``nvidia-smi`` with ``args`` (by default each card's name and power
    limit, one line a card)."""
    args = args or ("--query-gpu=name,power.limit", "--format=csv,noheader")
    out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def quantiles(xs):
    import numpy as np

    if not xs:
        return {"n": 0}
    return {"n": len(xs), **{f"p{q}": float(np.percentile(xs, q)) for q in (50, 90, 99)},
            "max": float(max(xs))}


class HandleClient:
    """``serve_traffic``'s engine interface over a deployment handle: each
    ``generate`` streams one request through the serve router."""

    def __init__(self, handle):
        self.handle = handle

    def generate(self, prompt, request_id, **kw):
        yield from self.handle.stream({"prompt": prompt, "request_id": request_id, **kw},
                                      _method="generate", _timeout=600)


def stream_request(handle, request):
    """One request through a deployment handle: its tokens and their
    arrival times."""
    toks, times = [], []
    for tok in handle.stream(request, _method="generate", _timeout=600):
        toks.append(tok)
        times.append(time.perf_counter())
    return toks, times


def serve_traffic(engine, vocab: int, seed: int, lens=(64, 1024), prefix: int = SHARED_PREFIX):
    """SERVE_REQUESTS requests from SERVE_CLIENTS client threads, each
    thread sending its share one after another, so SERVE_CLIENTS are in
    flight and, after the first wave, admission and decode overlap.
    Prompt lengths are drawn from ``lens`` (64-1024) by ``seed``; request 1
    is request 0's ``prefix`` (512 tokens) exactly (a full-prompt prefix
    hit: COW) and is sent once request 0's prompt is cached; even requests
    are greedy, odd ones sample at temperature 0.8 with fixed seeds.
    ``engine`` is an ``InferenceEngine`` or a ``HandleClient``. Returns
    each request's (prompt, kwargs, tokens, submit time, token arrival
    times); raises a client's first error."""
    import threading

    import numpy as np

    rs = np.random.RandomState(seed)
    lo, hi = lens
    n_tokens = rs.randint(lo, hi + 1, size=SERVE_REQUESTS)
    n_tokens[0] = max(n_tokens[0], prefix + lo)
    prompts = [[int(x) for x in rs.randint(1, vocab, size=n)] for n in n_tokens]
    prompts[1] = prompts[0][:prefix]
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
        except Exception as e:  # noqa: BLE001 — re-raised on the caller's thread
            errors.append(e)
            first_cached.set()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("serve traffic: a client thread still runs after 600 s")
    if errors:
        raise errors[0]
    return results
