"""LLMServer: one serving replica — model params plus the continuous-batching
engine (port of ``ray_tpu.inference.serve_llm.LLMServer``).

It runs in-process, as the reference's tests build one, or as the replica
of a serve deployment (:func:`llm_deployment`, below). Tokens stream out
of :meth:`LLMServer.generate` as
:class:`~ray_tpu_torch.core.streaming.TokenChunk` bursts, or, in resume
mode, as ``(seq, token)`` pairs:

    from ray_tpu_torch.inference import EngineConfig, LLMServer
    from ray_tpu_torch.models.llama import LlamaConfig

    server = LLMServer(LlamaConfig.tiny(), EngineConfig(warmup=False), device="cpu")
    tokens = server({"prompt": [3, 7, 11], "max_new_tokens": 8})["tokens"]

Retry semantics: ``generate`` is declared in
:attr:`LLMServer.resumable_streams`. A stream interrupted after ``k``
delivered tokens resumes on a survivor with the prompt extended by those
tokens and ``resume_from=k``; deterministic continuation (engine sampling
keyed on ``(seed, position)``) makes the replayed stream byte-exact, and a
:class:`~ray_tpu_torch.core.streaming.SeqGate` on the consumer side drops
the boundary duplicates. The replay is sound ONLY because generation is
side-effect-free and deterministic given (params, request seed, prompt).

Behind the serve layer, :func:`llm_deployment` runs one ``LLMServer`` per
replica on the port's cluster:

    from ray_tpu_torch import serve

    handle = serve.run(serve.llm_deployment(
        cfg, ray_actor_options={"num_gpus": 1}).bind())
    for token in handle.stream({"prompt": [1, 2, 3]}, _method="generate"):
        ...

A replica serves on ``cuda`` unless ``bind(device=...)`` names another
device, whether it builds its params or is bound ``params=``; so on the
card it needs a GPU lease (``num_gpus=1``), and one without sees
``CUDA_VISIBLE_DEVICES=""`` and raises.

Not ported yet: the KV-migration and KV-tier paths (``prefill_export``,
``testing_arm_kv_tier_chaos``, ``begin_drain(migrate=True)``,
``llm_deployment(kv_tier=True)`` and ``llm_deployment(disaggregated=True)``;
ROADMAP Queue A item 4), which raise ``NotImplementedError``. A request
carrying a ``kv_import`` or ``kv_tier`` field runs as a plain prefill, the
reference's own fallback when no cluster can serve the fetch.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, Iterator, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.streaming import TokenChunk
from ray_tpu_torch.inference.engine import _NOT_PORTED, EngineConfig, InferenceEngine
from ray_tpu_torch.models.llama import LlamaConfig, init_params, resolve_device

#: the KV-migration and KV-tier paths wait for ROADMAP Queue A item 4
_KV_ITEM = "item 4, KV migration and the cluster KV tier"


class LLMServer:
    """One replica: model params + continuous-batching engine."""

    #: streaming methods that are safe to RESUME on another replica after
    #: a mid-stream death (serve router exactly-once token delivery).
    #: Sound here because generation is deterministic (same params +
    #: request seed + prompt → same tokens, engine sampling keyed on
    #: (seed, position)) and side-effect-free; anything that writes to
    #: the outside world per item must never appear in this tuple.
    resumable_streams = ("generate",)

    def __init__(
        self,
        model_cfg=None,
        engine_cfg=None,
        *,
        seed: int = 0,
        params=None,
        export_metrics: bool = True,
        device=None,
    ):
        """The server runs on ``device``: ``cuda`` unless it names another,
        raising when there is no card. ``params=None`` builds
        ``init_params(model_cfg, seed, device=device)``; given params are
        moved there (a module bound to a deployment reaches its replica as
        host tensors, and still serves on the replica's card)."""
        t0 = time.perf_counter()
        if model_cfg is None:
            model_cfg = LlamaConfig.tiny()
        self.model_cfg = model_cfg
        if params is None:
            params = init_params(model_cfg, seed, device=device)
        else:
            params = params.to(resolve_device(device))
        self.engine = InferenceEngine(
            model_cfg, params, engine_cfg or EngineConfig()
        ).start()
        self.engine.attach_node_drain_listener()
        self._init_s = time.perf_counter() - t0
        self._metrics_server = None
        if export_metrics and GLOBAL_CONFIG.metrics_export_enabled:
            # a replica exports the engine gauges from an auto-port
            # server of its own (address via metrics_address)
            from ray_tpu_torch.observability.metrics import MetricsServer

            self._metrics_server = MetricsServer(
                host=GLOBAL_CONFIG.metrics_bind_host, port=0
            )

    # -- request plumbing -------------------------------------------------
    @staticmethod
    def _parse(request) -> Dict[str, Any]:
        if isinstance(request, dict):
            if "prompt" not in request:
                raise ValueError("request dict needs a 'prompt' (list of token ids)")
            return dict(request)
        if isinstance(request, (list, tuple)):
            return {"prompt": list(request)}
        raise TypeError(
            f"request must be a dict or token list, got {type(request).__name__}"
        )

    def generate(self, request) -> Iterator[TokenChunk]:
        """Streaming entry: yields :class:`TokenChunk` bursts of token ids
        as they decode (one per engine wake-up). Request fields: prompt
        (required), max_new_tokens, temperature, priority, eos_token,
        request_id, seed, resume_from, speculative (per-request
        off-switch for a speculative engine — output bytes are identical
        either way).

        ``resume_from`` switches to seq-numbered mode: the prompt carries
        ``resume_from`` already-delivered tokens of an interrupted
        stream, and chunk elements become ``(seq, token)`` pairs so the
        consumer can suppress replayed duplicates at the failover
        boundary. ``max_new_tokens`` stays the ORIGINAL request's cap —
        the replica subtracts what was already delivered, so the
        client-visible stream length never changes across failovers.

        A ``kv_import`` (disaggregated handoff) or ``kv_tier`` (cluster
        KV-tier fault-in) field is dropped and the request runs as a
        plain prefill: the reference's own fallback rung when no cluster
        can serve the fetch, which gives the same tokens."""
        r = self._parse(request)
        resume_from = r.get("resume_from")
        tenant_class = str(r.get("tenant_class") or "")
        # resumable streams are observed into the SLO latency histograms
        # by the ROUTER (slo_observer="router"); a resume attempt's
        # artificially fast warm replay (resume_attempt>=1) never lands
        # as its own sample. The engine observes only for requests no
        # router is watching (direct callers, non-resumable streams).
        record_slo = not (
            r.get("resume_attempt") or r.get("slo_observer") == "router"
        )
        r.pop("kv_import", None)
        r.pop("kv_tier", None)
        if resume_from is None:
            # bursts ride ONE stream item each: a speculative engine
            # commits up to k+1 tokens per verify step
            for chunk in self.engine.generate_chunks(
                r["prompt"],
                max_new_tokens=r.get("max_new_tokens"),
                temperature=float(r.get("temperature", 0.0)),
                priority=int(r.get("priority", 0)),
                eos_token=r.get("eos_token"),
                request_id=r.get("request_id"),
                seed=r.get("seed"),
                tenant_class=tenant_class,
                record_slo=record_slo,
                speculative=r.get("speculative"),
            ):
                yield TokenChunk(chunk)
            return
        seq = int(resume_from)
        max_new = r.get("max_new_tokens")
        if max_new is None:
            max_new = self.engine.engine_cfg.max_new_tokens_default
        # the cap the ORIGINAL run actually obeyed: the engine clamps
        # max_new_tokens to the context room (max_seq_len - prompt), so
        # a room-clamped stream ends early — resume math must use the
        # clamped cap, or a death exactly after the last clamped token
        # would resubmit with remaining>0 and a full-context prompt,
        # raising "prompt >= max_seq_len" instead of closing cleanly
        orig_prompt_len = len(r["prompt"]) - seq
        effective_cap = min(
            int(max_new), max(0, self.engine.cfg.max_seq_len - orig_prompt_len)
        )
        remaining = effective_cap - seq
        if remaining <= 0:
            # the whole (clamped) budget was delivered before the
            # failover: the resume covers only the end-of-stream signal
            return
        eos = r.get("eos_token")
        if eos is not None and seq > 0 and r["prompt"][-1] == eos:
            # the stream already ENDED at this EOS — it was delivered,
            # then the replica died before the end-of-stream signal. The
            # engine's EOS check applies only to SAMPLED tokens, so
            # decoding past the replayed EOS would emit tokens an
            # undisturbed run never produced.
            return
        for chunk in self.engine.generate_chunks(
            r["prompt"],
            max_new_tokens=remaining,
            temperature=float(r.get("temperature", 0.0)),
            priority=int(r.get("priority", 0)),
            eos_token=r.get("eos_token"),
            request_id=r.get("request_id"),
            seed=r.get("seed"),
            tenant_class=tenant_class,
            record_slo=record_slo,
            speculative=r.get("speculative"),
        ):
            yield TokenChunk((seq + i, tok) for i, tok in enumerate(chunk))
            seq += len(chunk)

    def __call__(self, request) -> Dict[str, Any]:
        """Non-streaming: returns the full generation in one reply."""
        return {"tokens": [t for chunk in self.generate(request) for t in chunk]}

    # -- disaggregated prefill/decode (not ported yet) --------------------
    def prefill_export(self, request) -> Optional[Dict[str, Any]]:
        """Prefill-pool entry of the disaggregated two-stage dispatch."""
        raise NotImplementedError("prefill_export " + _NOT_PORTED.format(_KV_ITEM))

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued/running request by id; frees its KV blocks.
        Closing a ``generate`` stream cancels its request too — this is
        the escape hatch for callers that tracked only the request id."""
        return self.engine.cancel(str(request_id))

    # -- introspection ----------------------------------------------------
    def set_deployment_name(self, name: str) -> None:
        """Stamps the deployment label onto the engine's SLO
        histograms/counters before any request arrives."""
        self.engine.set_deployment_name(name)

    def slo_snapshot(self) -> Dict[str, Any]:
        """SLO-ledger dump: this process's latency histograms + flight
        recorder, plus the engine's intake books (exact conservation:
        submitted == finished + failed + cancelled + in-flight)."""
        return self.engine.slo_snapshot()

    def engine_stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def routing_stats(self) -> Dict[str, Any]:
        """Load + prefix-digest gossip consumed by the serve router's
        cache-affinity scoring."""
        return self.engine.routing_stats()

    def metrics_address(self) -> Optional[str]:
        if self._metrics_server is None:
            return None
        return f"{self._metrics_server.host}:{self._metrics_server.port}"

    def testing_device_info(self) -> Dict[str, Any]:
        """Test hook: where this replica runs (the port's own; the reference's replica
        runs on the TPU its process owns): its pid and
        ``CUDA_VISIBLE_DEVICES``, the engine's device and, on a card, its
        name and this process's peak allocated memory; the seconds the
        server took to build (params, engine, warmup); the f32 matmul
        precision; and the launches of the port's flash-attention kernels
        in this process (the serving path has none)."""
        import torch

        from ray_tpu_torch.ops import attention

        dev = self.engine.runner.device
        on_card = dev.type == "cuda"
        return {
            "pid": os.getpid(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if on_card else None,
            "max_memory_allocated_bytes": (
                torch.cuda.max_memory_allocated(dev) if on_card else None),
            "init_s": self._init_s,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "flash_launches": {fn.__name__: fn.launches for fn in attention.KERNELS},
        }

    def begin_drain(
        self, grace_s: Optional[float] = None, migrate: bool = False
    ) -> None:
        """Drain without a node event. ``migrate=True`` (hand in-flight
        KV to the cluster tier) raises in the engine: not ported yet."""
        self.engine.begin_drain(grace_s, migrate=migrate)

    def check_health(self) -> bool:
        """False once the engine's step loop is dead or wedged — the
        signal that gets a stalled replica restarted (engine.healthy())."""
        return self.engine.healthy()

    def testing_arm_replica_chaos(self, spec: str, seed: int) -> int:
        """Test hook: install a ReplicaFaultPlan on THIS replica only
        (the env/config plan arms every replica in the process).
        Returns the seed."""
        from ray_tpu_torch.util.chaos import ReplicaFaultPlan

        self.engine.testing_fault_plan = ReplicaFaultPlan(spec, seed)
        return seed

    def testing_arm_kv_tier_chaos(self, spec: str, seed: int) -> int:
        """Test hook of the KV tier's fault plan."""
        raise NotImplementedError(
            "testing_arm_kv_tier_chaos " + _NOT_PORTED.format(_KV_ITEM)
        )

    def __del__(self):
        if sys is None or sys.is_finalizing():
            # interpreter exit (late in it, this module's globals are
            # already None): the engine and metrics threads are daemons
            # that can no longer run, so joining or shutting them down
            # here would wait on them forever
            return
        try:
            self.engine.stop()
            if self._metrics_server is not None:
                self._metrics_server.stop()
        except Exception:
            pass


def llm_deployment(
    model_cfg=None,
    *,
    engine: Any = None,
    name: str = "llm",
    num_replicas: int = 1,
    max_concurrent_queries: int = 32,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    route_prefix: Optional[str] = "/llm",
    seed: int = 0,
    autoscaling_config=None,
    version: Optional[str] = None,
    kv_tier: bool = False,
    disaggregated: bool = False,
):
    """Build a Serve deployment serving ``model_cfg`` through a
    continuous-batching engine (the ``serve.llm`` entry point).

    ``serve.run(llm_deployment(cfg).bind())`` → DeploymentHandle whose
    ``stream(request, _method="generate")`` yields tokens and whose
    ``remote(request)`` returns the whole generation. ``num_replicas``
    scales out: each replica hosts its own engine (same ``seed`` → same
    params → identical generations), and the router scores replicas by
    outstanding tokens blended with prefix-cache affinity. Pin
    ``version`` to make a num_replicas redeploy an in-place scale instead
    of a rolling replacement.

    ``bind(**overrides)`` passes ``seed`` and any override through to
    :class:`LLMServer`: ``device=`` (a replica serves on ``cuda`` unless
    told otherwise) or ``params=`` (a param module, shipped to each
    replica as host bytes and moved onto the replica's device). On the
    card give each replica a GPU lease with ``ray_actor_options={"num_gpus":
    1}``; on the CPU bind ``device="cpu"``, with ``params=`` too.

    ``kv_tier=True`` and ``disaggregated=True`` (the cluster KV prefix
    tier and the split prefill/decode pools) are not ported yet and
    raise ``NotImplementedError``; the reference's options of the split
    pools (``prefill_replicas``, ``decode_replicas``,
    ``prefill_autoscaling_config``, ``prefill_actor_options``) come with
    them."""
    if kv_tier or disaggregated:
        feature = "disaggregated=True" if disaggregated else "kv_tier=True"
        raise NotImplementedError(
            f"llm_deployment({feature}) " + _NOT_PORTED.format(_KV_ITEM))
    from ray_tpu_torch import serve

    dep = serve.deployment(
        name=name,
        num_replicas=num_replicas,
        max_concurrent_queries=max_concurrent_queries,
        ray_actor_options=ray_actor_options,
        route_prefix=route_prefix,
        autoscaling_config=autoscaling_config,
        version=version,
    )(LLMServer)

    class _BoundDeployment:
        """Deployment with the model/engine config pre-bound."""

        def __init__(self, inner):
            self._inner = inner

        def bind(self, **overrides):
            kwargs = {"seed": seed, **overrides}
            return self._inner.bind(model_cfg, engine, **kwargs)

        def __getattr__(self, item):
            return getattr(self._inner, item)

    return _BoundDeployment(dep)
