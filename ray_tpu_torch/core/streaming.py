"""Stream item types of resumable token streams (port of the in-process
part of ``ray_tpu.core.streaming``).

``TokenChunk`` marks a coalesced burst of stream items (``LLMServer``
yields one per engine wake-up) and ``SeqGate`` is the consumer-side gate
of seq-numbered resumable streams: an interrupted stream is re-dispatched
to a survivor with ``resume_from`` set, and the gate suppresses replayed
duplicates so the client-visible sequence has no gaps and no repeats.
The runtime's streaming generators (``ObjectRefStream``,
``ObjectRefGenerator``, ``streaming_error_result``) wait for the runtime
(ROADMAP Queue A).
"""

from __future__ import annotations


class TokenChunk(list):
    """Marker for a COALESCED burst of stream items (serve token
    streaming): a producer that has several items ready at once — e.g. a
    speculative-decoding engine accepting k+1 tokens in one verify step
    — yields them as one ``TokenChunk`` so the burst rides ONE
    ObjectRef/get round trip instead of one per token. The serve router
    flattens chunks before clients see them, so the consumer-visible
    stream is unchanged; the subclass (not a bare list) is what lets the
    router distinguish a coalesced burst from a deployment whose stream
    legitimately yields list VALUES."""

    __slots__ = ()


class SeqGate:
    """Consumer-side duplicate/gap gate for seq-numbered resumable
    streams (serve router exactly-once token delivery).

    Every item of a resumable stream is a ``(seq, value)`` pair with a
    per-request monotonic seq. The gate admits exactly the item whose
    seq it expects next; anything below is a replayed duplicate (a
    failed-over producer re-emitting the boundary item the consumer
    already delivered) and is suppressed; anything above is a protocol
    violation — a resumed producer must start exactly at ``next_seq``,
    so a gap can only mean lost delivery, which must fail loudly rather
    than silently skip items."""

    __slots__ = ("next_seq",)

    def __init__(self, start: int = 0):
        self.next_seq = int(start)

    def admit(self, seq: int) -> bool:
        """True → deliver (and advance); False → suppress a duplicate.
        Raises RuntimeError on a gap."""
        seq = int(seq)
        if seq == self.next_seq:
            self.next_seq += 1
            return True
        if seq < self.next_seq:
            return False
        raise RuntimeError(
            f"resumable stream gap: expected seq {self.next_seq}, got {seq}"
        )
