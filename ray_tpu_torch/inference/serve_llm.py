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

``llm_deployment(cfg, disaggregated=True)`` splits prefill from decode
onto two pools: the router runs :meth:`LLMServer.prefill_export` on a
prefill replica and hands the descriptor to a decode replica in the
request's ``kv_import`` field, which imports the blocks and decodes from a
one-token tail. ``llm_deployment(cfg, kv_tier=True)`` opts every replica
into the cluster KV tier: the router attaches the advertised blocks of a
prompt's prefix as ``kv_tier``, which the replica faults in, and
``begin_drain(migrate=True)`` hands live streams to a survivor through the
tier. Every failure of a migration degrades, counted, to a plain prefill
with the same tokens.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.streaming import TokenChunk
from ray_tpu_torch.inference import kv_transfer
from ray_tpu_torch.inference.engine import EngineConfig, InferenceEngine
from ray_tpu_torch.models.llama import LlamaConfig, init_params, resolve_device
from ray_tpu_torch.observability import rpc_metrics
from ray_tpu_torch.observability.slo import slo_metrics


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

        ``kv_import`` (a :meth:`prefill_export` descriptor, attached by
        the router's disaggregated dispatch) installs the exported
        blocks before the submit, so the request admits them as a prefix
        hit; ``kv_tier`` (the router's tier chain for the prompt) faults
        the advertised blocks in, on every attempt. Any failure of
        either degrades, counted, to a plain prefill: the stream never
        fails because of a migration."""
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
        ledger_stages = {}
        desc = r.pop("kv_import", None)
        if desc is not None and not resume_from:
            # not resume_from: attempt 0 of a resumable stream carries
            # resume_from=0, and 0 delivered tokens means the prompt is
            # still the one the descriptor was exported for
            t0 = time.monotonic()
            self._import_kv(desc, r["prompt"])
            # ledger stage: the fetch + scatter ran BEFORE submit, so its
            # cost is handed to the engine's ledger as a pre-stage
            ledger_stages["kv_import"] = time.monotonic() - t0
        tier = r.pop("kv_tier", None)
        if tier is not None:
            # unlike kv_import this runs on EVERY attempt: on a resume
            # the prompt already carries the delivered tokens, and the
            # router re-attached descriptors for the extended chain, so
            # a failover's replay becomes tier hits instead of prefill
            t0 = time.monotonic()
            committed = self._import_tier(tier, r["prompt"])
            ledger_stages["kv_tier"] = time.monotonic() - t0
            self._reconcile_tier_replay(tier, r["prompt"], resume_from, committed)
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
                ledger_stages=ledger_stages,
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
            ledger_stages=ledger_stages,
            record_slo=record_slo,
            speculative=r.get("speculative"),
        ):
            yield TokenChunk((seq + i, tok) for i, tok in enumerate(chunk))
            seq += len(chunk)

    def __call__(self, request) -> Dict[str, Any]:
        """Non-streaming: returns the full generation in one reply."""
        return {"tokens": [t for chunk in self.generate(request) for t in chunk]}

    # -- disaggregated prefill/decode (inference/kv_transfer.py) ----------
    def prefill_export(self, request) -> Optional[Dict[str, Any]]:
        """Prefill-pool entry of the disaggregated two-stage dispatch:
        run ONLY the prompt's prefill (no token sampled), publish the
        gathered KV blocks through the local daemon's store (inline in
        the descriptor without one), and return the migration descriptor
        the router attaches to the decode dispatch. The descriptor's
        ``dtype`` is the payload's host type (``uint16`` for bf16 bits).
        Returns None when the prompt spans no full block — nothing worth
        migrating."""
        r = self._parse(request)
        payload = self.engine.prefill_kv(
            r["prompt"],
            priority=int(r.get("priority", 0)),
            request_id=r.get("request_id"),
        )
        if payload is None:
            return None
        return kv_transfer.publish(payload)

    def _layout_ok(self, desc: Dict[str, Any], n_blocks: Optional[int]) -> bool:
        """Whether a descriptor's payload fits this engine's cache: six
        dimensions matching the cache's (``n_blocks`` None: any block
        count), the block size, and the host type of the cache's element
        type (the port ships bf16 as ``uint16`` bits, so comparing with
        the cache tensor's own dtype would refuse every handoff)."""
        runner = self.engine.runner
        L, _, bs, n_kv, hd = runner.cache["k"].shape
        expect = (2, L, n_blocks, bs, n_kv, hd)
        shape = tuple(desc.get("shape") or ())
        return (
            len(shape) == 6
            and int(desc.get("block_size") or 0) == self.engine.blocks.block_size
            and all(e is None or s == e for s, e in zip(shape, expect))
            and str(desc.get("dtype")) == str(runner.kv_host_dtype)
        )

    def _import_kv(self, desc: Dict[str, Any], prompt) -> bool:
        """Decode-pool half: fetch the descriptor's payload (zero-copy
        pull path, digest-before-attach) and scatter it into this
        engine's cache + radix index. Failure ladder: every exception is
        swallowed into a counted fallback — the caller proceeds with a
        plain prefill."""
        eng = self.engine
        try:
            if not self._layout_ok(desc, None):
                kv_transfer.count_failure("shape")
                kv_transfer.count_fallback("shape_mismatch")
                return False
            fetched = kv_transfer.fetch(
                desc, timeout_s=GLOBAL_CONFIG.serve_disagg_handoff_timeout_s
            )
            try:
                covered = eng.import_kv_blocks(
                    [int(t) for t in prompt[: int(desc["tokens"])]],
                    fetched.array,
                )
            finally:
                # the import's scatter copied every chunk to the device
                # before the reply: the shared memory may go now
                fetched.close()
            return covered > 0
        except kv_transfer.KvTransferError:
            kv_transfer.count_fallback("transfer")
            return False
        except Exception:  # noqa: BLE001 — migration must never fail a stream
            kv_transfer.count_failure("import")
            kv_transfer.count_fallback("import")
            return False

    def _import_tier(self, spec: Dict[str, Any], prompt) -> int:
        """Cluster KV-tier consumer: fault the router-attached prefix
        blocks in (zero-copy pull, digest-before-attach, keep_source —
        tier reads never consume the entry) and commit them into this
        engine's cache. ``spec`` is ``{"blocks": [[digest_hex, desc],
        ...]}`` — a consecutive root-anchored chain the router matched
        against the request's tokens, so a fetched block's KV provably
        belongs to exactly that token prefix (chain-digest keying).

        Counted fallback ladder, longest-valid-prefix semantics: the
        first block that fails STOPS the chain (later blocks would be
        unreachable in the radix index anyway) and everything already
        fetched still commits. Returns the number of tokens committed;
        0 means the caller proceeds on plain prefix replay / cold
        prefill, byte-exact either way."""
        eng = self.engine
        blocks = list(spec.get("blocks") or ())
        if not blocks:
            return 0
        bs = eng.blocks.block_size
        fetched: List[Any] = []
        try:
            for _digest_hex, desc in blocks:
                if str(desc.get("tier_ns") or "") != eng._tier_ns:
                    # model-identity gate: the chain digest names the
                    # TOKENS, not the weights that computed the KV — a
                    # descriptor of another deployment's namespace passes
                    # every shape/dtype check yet holds another model's KV
                    rpc_metrics.KV_TIER_FALLBACKS.inc(labels={"reason": "namespace"})
                    break
                if not self._layout_ok(desc, 1):
                    rpc_metrics.KV_TIER_FALLBACKS.inc(labels={"reason": "shape"})
                    break
                try:
                    payload = kv_transfer.tier_fetch(
                        desc, timeout_s=GLOBAL_CONFIG.serve_disagg_handoff_timeout_s
                    )
                except kv_transfer.KvTransferError as e:
                    msg = str(e)
                    reason = (
                        "missing" if "missing" in msg
                        else "digest" if "digest" in msg
                        else "transfer"
                    )
                    rpc_metrics.KV_TIER_FALLBACKS.inc(labels={"reason": reason})
                    break
                fetched.append(payload)
            if not fetched:
                return 0
            verdict = kv_transfer.consult_tier_chaos("migration")
            if verdict is not None and verdict[0] == "kill_mid_migration":
                # die exactly like a replica lost mid-migration: blocks
                # fetched, nothing committed, process gone without a
                # goodbye; the router's resume is the fallback rung
                os.kill(os.getpid(), signal.SIGKILL)
            kv = (
                fetched[0].array
                if len(fetched) == 1
                else np.concatenate([f.array for f in fetched], axis=2)
            )
            covered = len(fetched) * bs
            n = eng.import_kv_blocks([int(t) for t in prompt[:covered]], kv)
            if n > 0:
                rpc_metrics.KV_TIER_HITS.inc(n // bs)
                rpc_metrics.KV_TIER_BYTES.inc(
                    sum(int(f.array.nbytes) for f in fetched),
                    labels={"direction": "fault_in"},
                )
            return int(n)
        except Exception:  # noqa: BLE001 — fault-in must never fail a stream
            rpc_metrics.KV_TIER_FALLBACKS.inc(labels={"reason": "import"})
            return 0
        finally:
            for f in fetched:
                f.close()

    def _reconcile_tier_replay(
        self, spec: Optional[Dict[str, Any]], prompt, resume_from, committed: int
    ) -> None:
        """Replay accounting for RESUME attempts: the router books
        ``replayed=0`` when the attached chain COVERS the stream,
        trusting the fault-in — but only this side knows whether it
        landed. When a covered chain commits short (fallback ladder),
        the positions the router assumed warm get re-prefilled here, and
        the delivered-region share of that work is real replay — book
        the shortfall into the same sinks the router uses."""
        try:
            seq = int(resume_from or 0)
            if seq <= 0 or not spec:
                return
            n_blocks = len(spec.get("blocks") or ())
            tokens = int(spec.get("tokens") or 0)
            if n_blocks <= 0 or tokens <= 0:
                return
            bs = tokens // n_blocks
            prompt_len = len(prompt)
            if tokens < prompt_len - bs:
                return  # not covered: the router counted the replay
            # positions assumed warm but re-prefilled, clipped to the
            # delivered region (re-prefilling the ORIGINAL prompt is
            # prompt work any attempt-0 request pays too, not replay)
            owed = max(0, tokens - max(int(committed), prompt_len - seq))
            if owed <= 0:
                return
            rpc_metrics.STREAM_RESUME_REPLAY_TOKENS.inc(owed)
            slo_metrics()["fault"].inc(
                owed,
                labels={
                    "deployment": self.engine.slo_deployment,
                    "reason": "resume_replay",
                },
            )
        except Exception:  # noqa: BLE001 — accounting never fails a stream
            pass

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
        """Drain without a node event. ``migrate=True`` (tier-enabled
        engines only) additionally hands every in-flight decode's FULL
        KV — prompt plus generated — to the tier and fails the requests
        with the resumable migration marker, so the router moves each
        stream to a survivor that admits it as tier hits."""
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
        """Test hook: install a KvTierFaultPlan in THIS process's
        kv_transfer module only (the env plan would arm every process,
        controller replacements included). Returns the seed."""
        from ray_tpu_torch.util.chaos import KvTierFaultPlan

        kv_transfer.testing_tier_plan = KvTierFaultPlan(spec, seed)
        return seed

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
    prefill_replicas: int = 1,
    decode_replicas: Optional[int] = None,
    prefill_autoscaling_config=None,
    prefill_actor_options: Optional[Dict[str, Any]] = None,
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

    ``disaggregated=True`` splits prefill from decode onto two replica
    pools: a sibling ``{name}-prefill`` deployment (``prefill_replicas``
    / ``prefill_autoscaling_config`` / ``prefill_actor_options``, which
    default to ``ray_actor_options``) computes prompt KV and exports it;
    the decode pool (``decode_replicas``, default ``num_replicas``)
    imports the blocks as prefix-cache hits and streams from a 1-token
    tail prefill. ``serve.run(dep.bind())`` deploys BOTH pools (both get
    the bind's overrides) and hands back the decode pool's handle; the
    two-stage dispatch lives in the router, keyed off the deployment's
    ``disagg_prefill``. Both engines get ``kv_transfer_enabled`` forced
    on. A failed handoff degrades to plain generation — the token stream
    never changes. On cards each pool needs a GPU of its own.

    ``kv_tier=True`` opts every replica into the cluster-wide KV prefix
    tier: engines write popular full prefix blocks back into daemon-owned
    tier storage and advertise them through the routing gossip, replicas
    fault advertised prefixes in, and mid-stream failovers resume as tier
    hits instead of replayed prefill. Forces ``kv_transfer_enabled``
    too."""
    from ray_tpu_torch import serve

    if kv_tier:
        engine = dataclasses.replace(
            engine or EngineConfig(), kv_transfer_enabled=True, kv_tier_enabled=True
        )

    if not disaggregated:
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

    from ray_tpu_torch.serve import Deployment, DisaggApplication
    from ray_tpu_torch.serve.config import DeploymentConfig

    ec = engine or EngineConfig()
    if not ec.kv_transfer_enabled:
        ec = dataclasses.replace(ec, kv_transfer_enabled=True)
    prefill_name = f"{name}-prefill"
    decode_dep = Deployment(
        LLMServer,
        name,
        DeploymentConfig(
            num_replicas=decode_replicas or num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling=autoscaling_config,
            route_prefix=route_prefix,
            version=version,
            disagg_prefill=prefill_name,
        ),
    )
    prefill_dep = Deployment(
        LLMServer,
        prefill_name,
        DeploymentConfig(
            num_replicas=prefill_replicas,
            max_concurrent_queries=max_concurrent_queries,
            ray_actor_options=dict(prefill_actor_options or ray_actor_options or {}),
            autoscaling=prefill_autoscaling_config,
            route_prefix=None,
            version=version,
        ),
    )

    class _BoundDisagg:
        """Two-pool deployment bundle with the configs pre-bound.
        ``bind(**overrides)`` (``device=``, ``params=`` as for one pool)
        returns a :class:`serve.DisaggApplication` — ``serve.run``
        deploys the prefill pool first, then the decode pool, and hands
        back the decode pool's handle."""

        def __init__(self, decode, prefill):
            self._decode = decode
            self._prefill = prefill

        def bind(self, **overrides):
            kwargs = {"seed": seed, **overrides}
            app = DisaggApplication(self._decode, (model_cfg, ec), dict(kwargs))
            app.prefill_app = self._prefill.bind(model_cfg, ec, **kwargs)
            return app

        def __getattr__(self, item):
            return getattr(self._decode, item)

    return _BoundDisagg(decode_dep, prefill_dep)
