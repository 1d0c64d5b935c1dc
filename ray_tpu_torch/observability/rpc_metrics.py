"""The speculative-decoding metrics of ``ray_tpu.observability.rpc_metrics``
(the four ``LLM_SPEC_*`` the engine registers); the reference's RPC,
transport and serve counters are not ported yet."""

from __future__ import annotations

from ray_tpu_torch.observability.metrics import Counter, Gauge

# -- speculative decoding (inference/speculative.py + engine verify) --------
# The propose→verify→accept/rollback loop's books: how many draft
# tokens were proposed, how many the target's one-step verification
# accepted (every accepted draft is a decode step the engine skipped),
# and how often a mismatch forced a rollback of the drafted tail. The
# SLO goodput counter is unaffected by design — only ACCEPTED tokens
# ever enter ``generated``, so rejected draft work can never inflate
# the tok/s books.

#: draft tokens proposed (n-gram lookup or draft-model decode)
LLM_SPEC_PROPOSED = Counter(
    "raytpu_llm_spec_proposed_tokens_total",
    "speculative draft tokens proposed for verification",
)

#: proposed drafts that matched the target's deterministic sample and
#: were committed — byte-identical to what plain decode would emit
LLM_SPEC_ACCEPTED = Counter(
    "raytpu_llm_spec_accepted_tokens_total",
    "speculative draft tokens accepted by target verification",
)

#: verify windows whose drafted tail was (partially) rejected: the
#: write cursor rewound and the over-grown KV blocks were trimmed back
LLM_SPEC_ROLLBACKS = Counter(
    "raytpu_llm_spec_rollbacks_total",
    "speculative verify steps that rolled back rejected draft tokens",
)

#: windowed acceptance rate (accepted/proposed over the gauge-refresh
#: window) — the signal the adaptive-k controller steers on
LLM_SPEC_ACCEPTANCE = Gauge(
    "raytpu_llm_spec_acceptance_rate",
    "trailing-window speculative draft acceptance rate",
)
