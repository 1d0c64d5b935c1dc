"""ray_tpu_torch.inference — the continuous-batching LLM engine over a paged
KV cache (port of ``ray_tpu.inference``): ``InferenceEngine`` and its
``EngineConfig``, ``LLMServer`` (one serving replica: the engine behind
seq-numbered resumable streams) and ``llm_deployment`` (``LLMServer``
replicas behind the serve router), the ``PagedModelRunner`` that runs the
port's paged Llama steps where the params live, the host-side
``PagedBlockManager`` and the ``ContinuousBatchingScheduler``.

    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny()
    engine = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"),
                             EngineConfig(warmup=False)).start()
    tokens = list(engine.generate([1, 2, 3], max_new_tokens=8))
    engine.stop()

``LLMServer(cfg, EngineConfig(warmup=False), device="cpu")`` wraps the same
engine; ``list(server.generate({"prompt": [1, 2, 3], "resume_from": 0}))``
streams ``(seq, token)`` bursts.

Submodules import lazily (PEP 562), as in the reference: ``kv_cache``,
``scheduler`` and ``kv_transfer`` are pure python, but
``engine``/``model_runner``/``serve_llm`` pull in torch, and the serve
router's processes import ``kv_cache`` for prefix scoring without it.
"""

from __future__ import annotations

_LAZY = {
    "PagedBlockManager": "ray_tpu_torch.inference.kv_cache",
    "ContinuousBatchingScheduler": "ray_tpu_torch.inference.scheduler",
    "Request": "ray_tpu_torch.inference.scheduler",
    "StepPlan": "ray_tpu_torch.inference.scheduler",
    "EngineConfig": "ray_tpu_torch.inference.engine",
    "InferenceEngine": "ray_tpu_torch.inference.engine",
    "EngineDrainingError": "ray_tpu_torch.inference.engine",
    "RequestFailedError": "ray_tpu_torch.inference.engine",
    "PagedModelRunner": "ray_tpu_torch.inference.model_runner",
    "llm_deployment": "ray_tpu_torch.inference.serve_llm",
    "LLMServer": "ray_tpu_torch.inference.serve_llm",
}

# torch-free names only: star-imports resolve every __all__ entry through
# __getattr__, and engine/model_runner/serve_llm pull in torch. The
# torch-backed names stay reachable by attribute.
__all__ = [
    "PagedBlockManager",
    "ContinuousBatchingScheduler",
    "Request",
    "StepPlan",
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
