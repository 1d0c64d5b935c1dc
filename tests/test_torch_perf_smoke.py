"""``tests/test_perf_smoke.py``, all 6 cases, against the port (loaded and
renamed by ``tests/_torch_suites.py``): the submit hot path, the engine's
decode floor, the warm-prefix TTFT, the ingress HTTP path floor, and the
RAW chunk receive path with the receive pool. Every floor is the
reference's.

Statements that differ from the reference, and why:

* the two engine cases ask for torch where the reference asks for JAX,
  and build the port's ``init_params(cfg, 0, device="cpu")``: the port's
  params come from an integer seed on a named device (``cuda`` unless
  told otherwise), not from a JAX key;
* the ingress case asks for torch where the reference asks for JAX, and
  binds its LLM deployment with ``device="cpu"``: a port replica serves
  on ``cuda`` unless told otherwise.

The cluster's processes run with one OpenMP thread (``one_thread``).
"""

from _torch_suites import load

_PARAMS = 'params = init_params(cfg, 0, device="cpu")'

EDITS = (
    (
        '    jax = pytest.importorskip("jax")\n'
        "    from ray_tpu.inference.engine import EngineConfig, InferenceEngine\n"
        "    from ray_tpu.models.llama import LlamaConfig, init_params\n"
        "    from ray_tpu.observability import slo\n"
        "\n"
        "    cfg = LlamaConfig.tiny()\n"
        "    params = init_params(cfg, jax.random.PRNGKey(0))\n",
        '    pytest.importorskip("torch")\n'
        "    from ray_tpu.inference.engine import EngineConfig, InferenceEngine\n"
        "    from ray_tpu.models.llama import LlamaConfig, init_params\n"
        "    from ray_tpu.observability import slo\n"
        "\n"
        "    cfg = LlamaConfig.tiny()\n"
        f"    {_PARAMS}\n",
        "decode floor: the port's engine needs torch, and its params come "
        "from an integer seed on a named device",
    ),
    (
        '    jax = pytest.importorskip("jax")\n'
        "    from ray_tpu.inference.engine import EngineConfig, InferenceEngine\n"
        "    from ray_tpu.models.llama import LlamaConfig, init_params\n"
        "\n"
        "    cfg = LlamaConfig.tiny(max_seq_len=512)\n"
        "    params = init_params(cfg, jax.random.PRNGKey(0))\n",
        '    pytest.importorskip("torch")\n'
        "    from ray_tpu.inference.engine import EngineConfig, InferenceEngine\n"
        "    from ray_tpu.models.llama import LlamaConfig, init_params\n"
        "\n"
        "    cfg = LlamaConfig.tiny(max_seq_len=512)\n"
        f"    {_PARAMS}\n",
        "warm prefix: the port's engine needs torch, and its params come "
        "from an integer seed on a named device",
    ),
    (
        '    pytest.importorskip("jax")\n    import threading\n',
        '    pytest.importorskip("torch")\n    import threading\n',
        "ingress floor: the port's engine needs torch, not JAX",
    ),
    (
        "serve.run(serve.llm_deployment(LlamaConfig.tiny(), engine=ec).bind())",
        'serve.run(serve.llm_deployment(LlamaConfig.tiny(), engine=ec).bind(device="cpu"))',
        "a port replica serves on cuda unless told otherwise",
    ),
)

load(globals(), "perf_smoke", edits=EDITS, one_thread=True)
