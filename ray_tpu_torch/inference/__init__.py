"""ray_tpu_torch.inference — the continuous-batching LLM engine over a paged
KV cache (port of ``ray_tpu.inference``): ``InferenceEngine`` and its
``EngineConfig``, ``LLMServer`` (one serving replica in-process: the engine
behind seq-numbered resumable streams), the ``PagedModelRunner`` that runs the port's paged Llama
steps where the params live, the host-side ``PagedBlockManager`` and the
``ContinuousBatchingScheduler``.

    from ray_tpu_torch.inference import EngineConfig, InferenceEngine
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny()
    engine = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"),
                             EngineConfig(warmup=False)).start()
    tokens = list(engine.generate([1, 2, 3], max_new_tokens=8))
    engine.stop()

``LLMServer(cfg, EngineConfig(warmup=False), device="cpu")`` wraps the same
engine; ``list(server.generate({"prompt": [1, 2, 3], "resume_from": 0}))``
streams ``(seq, token)`` bursts. The serve deployment (``llm_deployment``)
is not ported yet.
"""

from ray_tpu_torch.inference.engine import (
    EngineConfig,
    EngineDrainingError,
    InferenceEngine,
    RequestFailedError,
)
from ray_tpu_torch.inference.kv_cache import PagedBlockManager
from ray_tpu_torch.inference.model_runner import PagedModelRunner
from ray_tpu_torch.inference.serve_llm import LLMServer
from ray_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    StepPlan,
)

__all__ = [
    "ContinuousBatchingScheduler",
    "EngineConfig",
    "EngineDrainingError",
    "InferenceEngine",
    "LLMServer",
    "PagedBlockManager",
    "PagedModelRunner",
    "Request",
    "RequestFailedError",
    "StepPlan",
]
