"""KV-cache migration transport: replica→replica block shipping.

The handoff unit of disaggregated prefill/decode serving
(``serve_llm.llm_deployment(disaggregated=True)``): a prefill replica
runs ``engine.prefill_kv`` (export-after-prefill), this module PUBLISHES
the gathered block payload into the local daemon's shm store, and the
decode replica FETCHES it by asking *its* daemon to ``pull_object`` from
the source daemon — so migrated bytes ride the existing zero-copy data
plane end to end: RAW chunk frames received straight into the
destination segment, per-chunk CRC verification, whole-object digest
before seal (PR 8 + PR 11), resumable multi-source failover, admission
control. Nothing here re-implements transfer; the "object" is simply a
set of paged KV blocks, exactly the Ray-paper move of coordinating
specialized actors through the object plane.

Integrity ladder (digest-before-attach): the pull path verifies each
chunk CRC and the source-advertised whole-object digest before the
segment seals; :func:`fetch` additionally compares the store digest
against the CRC the *exporter* stamped into the descriptor — which also
covers the same-node short-circuit where no transfer ran at all. Only
then does the importing engine scatter the blocks into its cache.

Descriptors are small picklable dicts (they travel router→replica in
request payloads). When the process has no node daemon (local mode,
unit tests), the payload is carried INLINE in the descriptor up to
``kv_inline_max_bytes`` — same CRC gate, no data plane.

Lifetime: published segments are owned by the source daemon's store and
reaped after ``kv_export_ttl_s`` (the importer usually deletes its own
received copy immediately, recycling the segment into the daemon's
receive pool — ``ShmStore`` satellite). jax-free by design: routers and
ingress processes import this for the fallback/handoff metrics.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core.config import GLOBAL_CONFIG

logger = logging.getLogger(__name__)


class KvTransferError(RuntimeError):
    """A migration step failed (publish, pull, digest, import). Always
    recoverable: the caller degrades to plain single-replica generation
    under the existing resume machinery."""


#: message marker carried by the engine's ``KvMigrationHandoff`` failure
#: (live decode migration: a draining replica flushed the request's full
#: KV into the tier and failed the stream resumably). Lives here — not
#: in engine.py — so jax-free router processes can match it.
KV_MIGRATION_MARKER = "kv-tier migration handoff"


# -- metrics (registered once per process) ----------------------------------

_METRICS = None
_METRICS_LOCK = threading.Lock()


def migration_metrics():
    """``raytpu_kv_migration_*`` counters + the disagg handoff timer
    (README Observability catalog)."""
    global _METRICS
    if _METRICS is None:
        from ray_tpu_torch.observability.metrics import Counter, Histogram

        with _METRICS_LOCK:
            if _METRICS is None:
                _METRICS = {
                    "transfers": Counter(
                        "raytpu_kv_migration_transfers_total",
                        "KV block payloads successfully migrated "
                        "replica-to-replica",
                    ),
                    "bytes": Counter(
                        "raytpu_kv_migration_bytes_total",
                        "KV bytes carried by successful migrations",
                    ),
                    "failures": Counter(
                        "raytpu_kv_migration_failures_total",
                        "migration steps that failed, by stage",
                        ("stage",),
                    ),
                    "fallbacks": Counter(
                        "raytpu_kv_migration_fallbacks_total",
                        "requests degraded to plain generation, by reason",
                        ("reason",),
                    ),
                    "handoff": Histogram(
                        "raytpu_disagg_handoff_seconds",
                        "prefill-dispatch to KV-descriptor latency "
                        "(disaggregated serving handoff)",
                        buckets=(
                            0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                            0.5, 1.0, 2.5, 5.0, 10.0,
                        ),
                    ),
                }
    return _METRICS


def count_failure(stage: str) -> None:
    migration_metrics()["failures"].inc(labels={"stage": stage})


def count_fallback(reason: str) -> None:
    migration_metrics()["fallbacks"].inc(labels={"reason": reason})


# -- plumbing ---------------------------------------------------------------


def _backend():
    """The process's cluster backend, or None when there is no node
    daemon to publish through (local mode → inline descriptors)."""
    try:
        from ray_tpu_torch.core.api import _global_worker

        w = _global_worker()
        if w is None:
            return None
        be = w.backend
        if getattr(be, "daemon", None) is None or getattr(be, "io", None) is None:
            return None
        return be
    except Exception:  # noqa: BLE001 — absence of a backend is normal
        return None


def _kv_object_id(transfer_id: str):
    """Deterministic ObjectID for a transfer (the segment NAME is the
    capability, exactly like worker-created puts)."""
    from ray_tpu_torch.core.ids import ObjectID

    return ObjectID(
        hashlib.blake2b(
            b"kvx:" + transfer_id.encode(), digest_size=ObjectID.SIZE
        ).digest()
    )


#: published-but-unreleased exports: transfer_id -> (ObjectID, expiry)
_EXPORTS: Dict[str, Tuple[Any, float]] = {}
_EXPORTS_LOCK = threading.Lock()


def _reap_exports(be) -> None:
    now = time.monotonic()
    with _EXPORTS_LOCK:
        dead = [t for t, (_o, exp) in _EXPORTS.items() if now > exp]
        victims = [_EXPORTS.pop(t)[0] for t in dead]
    for oid in victims:
        try:
            be.io.run(
                be.daemon.call("delete_object", {"object_id": oid.binary()}),
                timeout=10,
            )
        except Exception:  # noqa: BLE001 — best-effort reap
            pass


def release_export(transfer_id: str) -> None:
    """Explicitly drop a published export (the TTL reap is the backstop
    for descriptors that never got consumed)."""
    with _EXPORTS_LOCK:
        ent = _EXPORTS.pop(transfer_id, None)
    if ent is None:
        return
    be = _backend()
    if be is None:
        return
    try:
        be.io.run(
            be.daemon.call("delete_object", {"object_id": ent[0].binary()}),
            timeout=10,
        )
    except Exception:  # noqa: BLE001
        pass


# -- publish (prefill side) -------------------------------------------------


def publish(payload: Dict[str, Any], *, transfer_id: Optional[str] = None) -> Dict[str, Any]:
    """Turn an ``engine.prefill_kv`` payload into a migration
    descriptor. The KV array is written ONCE into a fresh shm segment
    named after the transfer's ObjectID, which the local daemon adopts —
    from then on it is a normal store object any daemon can pull with
    full integrity/resume semantics. Raises :class:`KvTransferError`
    when nothing can carry the payload (no daemon AND too big to
    inline)."""
    kv = np.ascontiguousarray(payload["kv"])
    tokens: List[int] = list(payload["tokens"])
    tid = transfer_id or uuid.uuid4().hex[:16]
    desc: Dict[str, Any] = {
        "transfer_id": tid,
        "tokens": len(tokens),
        "block_size": int(payload["block_size"]),
        "shape": tuple(int(d) for d in kv.shape),
        "dtype": str(kv.dtype),
        "size": int(kv.nbytes),
        "inline": None,
        "object_id": None,
        "source": None,
    }
    be = _backend()
    if be is None:
        cap = GLOBAL_CONFIG.kv_inline_max_bytes
        if kv.nbytes > cap:
            count_failure("export")
            raise KvTransferError(
                f"no node daemon and payload of {kv.nbytes} bytes exceeds "
                f"kv_inline_max_bytes={cap}"
            )
        raw = kv.tobytes()
        desc["inline"] = raw
        desc["crc32"] = zlib.crc32(raw)
        return desc
    _reap_exports(be)
    from ray_tpu_torch.core.object_store import _attach, _create, segment_name

    oid = _kv_object_id(tid)
    name = segment_name(oid)
    try:
        try:
            seg = _create(name, kv.nbytes)
        except FileExistsError:
            # transfer-id collision can't happen (uuid) but tier ids are
            # DETERMINISTIC ("tier:<digest>") and a stale segment from a
            # crashed exporter can linger — overwrite in place either
            # way (idempotent republish: same digest → same bytes)
            seg = _attach(name)
        try:
            view = np.frombuffer(memoryview(seg.buf)[: kv.nbytes], dtype=kv.dtype)
            view[:] = kv.reshape(-1)
            desc["crc32"] = zlib.crc32(memoryview(seg.buf)[: kv.nbytes])
            del view
        finally:
            seg.close()
        be.io.run(
            be.daemon.call(
                "adopt_object", {"object_id": oid.binary(), "size": kv.nbytes}
            ),
            timeout=30,
        )
    except Exception as e:  # noqa: BLE001 — publish failure → fallback
        count_failure("export")
        raise KvTransferError(f"kv publish failed: {e!r}") from e
    desc["object_id"] = oid.hex()
    desc["source"] = tuple(be.daemon_addr)
    with _EXPORTS_LOCK:
        _EXPORTS[tid] = (
            oid, time.monotonic() + GLOBAL_CONFIG.kv_export_ttl_s,
        )
    return desc


# -- fetch (decode side) ----------------------------------------------------


class FetchedPayload:
    """A migrated KV array plus the cleanup that returns its segment.
    ``close()`` is safe to call with the array still referenced (the
    mapping outlives live views; the daemon-side delete recycles the
    inode into the receive-segment pool either way)."""

    def __init__(self, array: np.ndarray, close: Callable[[], None]):
        self.array = array
        self._close = close

    def close(self) -> None:
        try:
            self._close()
        except Exception:  # noqa: BLE001 — cleanup must never raise
            pass


def fetch(
    desc: Dict[str, Any], *, timeout_s: float = 30.0, keep_source: bool = False
) -> FetchedPayload:
    """Materialize a descriptor's KV payload locally. Remote descriptors
    ride ``pull_object`` on the local daemon (RAW receive-into-segment,
    per-chunk CRC, digest-verified seal, multi-source resume); the
    store digest is then compared against the exporter-stamped CRC
    before the array is handed to the importing engine — the
    digest-before-attach gate, which also covers the same-node
    short-circuit where no transfer ran.

    ``keep_source=True`` is the KV-tier read mode: the published object
    is a shared cache entry, not a single-consumer handoff, so close()
    must neither delete the source export (other replicas will fault
    the same prefix in) nor — in the same-node short-circuit, where the
    pulled segment IS the tier copy — delete the local object."""
    shape = tuple(desc["shape"])
    dtype = np.dtype(desc["dtype"])
    inline = desc.get("inline")
    if inline is not None:
        if zlib.crc32(inline) != desc["crc32"]:
            count_failure("digest")
            raise KvTransferError(
                "inline kv payload digest mismatch — refusing to attach"
            )
        arr = np.frombuffer(inline, dtype=dtype).reshape(shape)
        migration_metrics()["transfers"].inc()
        migration_metrics()["bytes"].inc(len(inline))
        return FetchedPayload(arr, lambda: None)
    be = _backend()
    if be is None:
        count_failure("transfer")
        raise KvTransferError("no node daemon to pull the kv payload through")
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_store import _attach

    oid = ObjectID(bytes.fromhex(desc["object_id"]))
    try:
        reply = be.io.run(
            be.daemon.call(
                "pull_object",
                {
                    "object_id": oid.binary(),
                    "sources": [tuple(desc["source"])],
                    "deadline_s": timeout_s,
                },
            ),
            timeout=timeout_s + 15,
        )
    except Exception as e:  # noqa: BLE001
        count_failure("transfer")
        raise KvTransferError(f"kv pull failed: {e!r}") from e
    if not (isinstance(reply, dict) and reply.get("segment")):
        count_failure("transfer")
        raise KvTransferError(f"kv pull failed: {reply!r}")
    try:
        info = be.io.run(
            be.daemon.call("object_info", {"object_id": oid.binary()}),
            timeout=30,
        )
    except Exception as e:  # noqa: BLE001
        count_failure("digest")
        raise KvTransferError(f"kv digest probe failed: {e!r}") from e
    digest = (info or {}).get("digest")
    if digest != desc["crc32"]:
        count_failure("digest")
        raise KvTransferError(
            f"kv payload digest mismatch: store={digest} descriptor="
            f"{desc['crc32']} — refusing to attach"
        )
    try:
        seg = _attach(reply["segment"])
    except Exception as e:  # noqa: BLE001
        count_failure("transfer")
        raise KvTransferError(f"kv segment attach failed: {e!r}") from e
    view = memoryview(seg.buf)[: desc["size"]]
    arr = np.frombuffer(view, dtype=dtype).reshape(shape)

    def _close():
        try:
            view.release()
        except BufferError:
            pass  # live numpy views keep the mapping valid
        try:
            seg.close()
        except Exception:  # noqa: BLE001
            pass
        src = tuple(desc["source"])
        same_node = src == tuple(be.daemon_addr)
        # the received copy is private to this transfer: delete it and
        # hand the inode to the daemon's receive-segment reuse pool so
        # the NEXT migration skips segment create/zero entirely.
        # EXCEPT keep_source + same-node: no transfer ran, the "received
        # copy" is the tier entry itself — deleting it here would purge
        # the tier on every local hit.
        if not (keep_source and same_node):
            try:
                be.io.run(
                    be.daemon.call(
                        "delete_object",
                        {"object_id": oid.binary(), "recycle_receive": True},
                    ),
                    timeout=10,
                )
            except Exception:  # noqa: BLE001
                pass
        # and release the SOURCE's export promptly — a consumed payload
        # parked until the TTL reap would occupy the prefill replica's
        # store for kv_export_ttl_s per migration, forcing spills of
        # LIVE objects under sustained traffic. Best-effort: the TTL
        # reap remains the backstop. (Same-node: the local delete above
        # already dropped the shared entry; this is then a no-op.
        # keep_source: the tier entry outlives every reader — lifetime
        # belongs to the holder daemon's registry TTL, never a reader.)
        if not keep_source and not same_node:
            try:
                be.io.run(
                    be._client(src[0], src[1], role="noded").call(  # noqa: SLF001
                        "delete_object", {"object_id": oid.binary()}
                    ),
                    timeout=10,
                )
            except Exception:  # noqa: BLE001
                pass

    migration_metrics()["transfers"].inc()
    migration_metrics()["bytes"].inc(desc["size"])
    return FetchedPayload(arr, _close)


# -- cluster-wide KV prefix tier (PR 17) ------------------------------------
#
# The tier promotes the point-to-point handoff above into a shared cache:
# engines write back popular full prefix blocks (spill-vs-drop policy in
# kv_cache.PagedBlockManager + explicit write-back at prefill/decode
# block boundaries), keyed by the 16-byte CHAIN DIGEST — the same
# capability-name trick as _kv_object_id, so republish is idempotent and
# any replica can derive the fetch capability from tokens alone. The
# holder's node daemon OWNS each entry (registry + TTL + cap eviction):
# tier state survives the replica process that wrote it, which is the
# whole warm-restart story. Readers fault blocks in over the zero-copy
# pull path with keep_source=True (see fetch) — a tier read never
# consumes the entry.
#
# Daemon-less processes (local mode, unit tests) fall back to a bounded
# in-process registry of inline descriptors: same API, same CRC gate,
# no data plane.

#: surgical KV-tier fault plan installed by tests via
#: ``LLMServer.testing_arm_kv_tier_chaos`` — wins over the env-driven
#: plan exactly like ``engine.testing_fault_plan``
testing_tier_plan = None

_PLAN_CACHE = None
_PLAN_CACHE_LOCK = threading.Lock()


def active_kv_tier_fault_plan():
    """Process-wide seeded KvTierFaultPlan from
    ``testing_kv_tier_chaos`` (or None); seed logged at activation."""
    global _PLAN_CACHE
    if _PLAN_CACHE is None:
        from ray_tpu_torch.util.chaos import KvTierFaultPlan, SeededPlanCache

        with _PLAN_CACHE_LOCK:
            if _PLAN_CACHE is None:
                _PLAN_CACHE = SeededPlanCache(
                    KvTierFaultPlan, "kv_tier",
                    "testing_kv_tier_chaos", "testing_kv_tier_chaos_seed",
                    logger,
                )
    return _PLAN_CACHE.active()


def consult_tier_chaos(phase: str):
    """One deterministic chaos consult for a tier phase (``"fault_in"``
    | ``"migration"``): ``(mode, param)`` or None. The surgically-armed
    plan wins over the env plan (same precedence as the engine's)."""
    plan = testing_tier_plan or active_kv_tier_fault_plan()
    if plan is None:
        return None
    return plan.consult(phase)


def tier_key(ns: str, digest_hex: str) -> str:
    """Registry/capability key for one tier entry: the chain digest,
    scoped by the publisher's model-identity namespace. The digest alone
    names only the TOKENS — two models given the same prompt compute the
    same chain, so an unscoped key would let one model's registry entry
    (and shm segment, via the deterministic capability name) collide
    with — and silently serve — another model's KV."""
    return f"{ns}:{digest_hex}" if ns else digest_hex


def tier_transfer_id(digest: bytes, ns: str = "") -> str:
    return "tier:" + tier_key(ns, digest.hex())


#: daemon-less fallback registry: digest hex -> inline descriptor,
#: oldest-first eviction at kv_tier_max_entries
from collections import OrderedDict as _OrderedDict  # noqa: E402

_LOCAL_TIER: "_OrderedDict[str, Dict[str, Any]]" = _OrderedDict()
_LOCAL_TIER_LOCK = threading.Lock()


def _tier_metrics():
    from ray_tpu_torch.observability import rpc_metrics as m

    return m


def tier_publish(
    digest: bytes, kv, block_size: int, *, ns: str = ""
) -> Optional[Dict[str, Any]]:
    """Write one full prefix block's KV back into the tier, keyed by its
    chain digest scoped under ``ns`` (the publisher's model-identity
    namespace — see :func:`tier_key`). Returns the (payload-free,
    routable) descriptor on success, None on failure — write-back is
    best-effort by design: a failed spill degrades to a drop, never to
    an engine error.

    With a daemon: the payload is published as a store object the
    DAEMON owns (adopt), then registered in the daemon's tier registry
    (which owns TTL/cap lifetime) — the local _EXPORTS TTL entry is
    deliberately NOT kept, a tier entry must outlive this process.
    Without one: bounded in-process inline registry."""
    key = tier_key(ns, digest.hex())
    try:
        kv = np.ascontiguousarray(kv)
        tid = tier_transfer_id(digest, ns)
        desc = publish(
            {"tokens": [0] * block_size, "kv": kv, "block_size": block_size},
            transfer_id=tid,
        )
    except KvTransferError:
        return None
    except Exception:  # noqa: BLE001 — never let write-back hurt serving
        return None
    desc["tier_digest"] = digest.hex()
    desc["tier_ns"] = ns
    be = _backend()
    if be is None:
        with _LOCAL_TIER_LOCK:
            _LOCAL_TIER[key] = desc
            _LOCAL_TIER.move_to_end(key)
            cap = max(1, GLOBAL_CONFIG.kv_tier_max_entries)
            while len(_LOCAL_TIER) > cap:
                _LOCAL_TIER.popitem(last=False)
        _tier_metrics().KV_TIER_BYTES.inc(desc["size"], labels={"direction": "publish"})
        return desc
    # lifetime transfer: the daemon registry owns the entry from here on
    # (registry eviction/TTL deletes the object); drop the exporter-side
    # TTL record so _reap_exports never kills a live tier entry
    with _EXPORTS_LOCK:
        _EXPORTS.pop(tid, None)
    routable = {k: v for k, v in desc.items() if k != "inline"}
    try:
        be.io.run(
            be.daemon.call(
                "kv_tier_put", {"digest": key, "desc": routable}
            ),
            timeout=10,
        )
    except Exception:  # noqa: BLE001 — unregistered entry = plain export
        # daemon didn't take ownership: restore the TTL reap so the
        # orphan segment can't leak forever
        with _EXPORTS_LOCK:
            _EXPORTS[tid] = (
                _kv_object_id(tid),
                time.monotonic() + GLOBAL_CONFIG.kv_export_ttl_s,
            )
        return None
    _tier_metrics().KV_TIER_BYTES.inc(desc["size"], labels={"direction": "publish"})
    return routable


def tier_fetch(desc: Dict[str, Any], *, timeout_s: float = 10.0) -> FetchedPayload:
    """Fault one tier block in: chaos consult, then a keep_source fetch
    (the entry stays resident for every other reader). Raises
    :class:`KvTransferError` on any failure — the caller's fallback
    ladder (next source → prefix replay → cold prefill) handles it."""
    verdict = consult_tier_chaos("fault_in")
    if verdict is not None:
        mode = verdict[0]
        if mode == "missing_block":
            count_failure("tier_missing")
            raise KvTransferError(
                "chaos missing_block: tier entry vanished between advert "
                "and fault-in"
            )
        if mode == "corrupt_block":
            # model a corrupted payload by breaking the expected CRC:
            # the digest-before-attach gate MUST fire and refuse it
            desc = dict(desc)
            desc["crc32"] = int(desc.get("crc32", 0)) ^ 0x5A5A5A5A
        elif mode == "stale_advert":
            # the holder dropped the entry but the retraction hasn't
            # reached this router yet: delete, then let the pull fail
            # FAST with no source (one-hop fall-through, not a timeout)
            tier_delete(
                tier_key(
                    str(desc.get("tier_ns") or ""),
                    str(desc.get("tier_digest") or ""),
                ),
                desc=desc,
            )
            desc = dict(desc)
            desc.pop("inline", None)  # inline copies can't go stale
    return fetch(desc, timeout_s=timeout_s, keep_source=True)


def tier_delete(key: str, *, desc: Optional[Dict[str, Any]] = None) -> None:
    """Drop one tier entry (registry + object), best-effort. ``key`` is
    the full registry key (:func:`tier_key` — digest hex, namespace-
    prefixed when the publisher had one). Used by the stale_advert
    chaos mode and by holders retracting entries."""
    with _LOCAL_TIER_LOCK:
        _LOCAL_TIER.pop(key, None)
    be = _backend()
    if be is None:
        return
    try:
        be.io.run(
            be.daemon.call("kv_tier_del", {"digest": key}), timeout=10
        )
    except Exception:  # noqa: BLE001
        pass
    # cross-node descriptors name their holder: delete there too so a
    # stale_advert injection actually removes the bytes the pull wants
    if desc and desc.get("source") and tuple(desc["source"]) != tuple(be.daemon_addr):
        src = tuple(desc["source"])
        try:
            be.io.run(
                be._client(src[0], src[1], role="noded").call(  # noqa: SLF001
                    "kv_tier_del", {"digest": key}
                ),
                timeout=10,
            )
        except Exception:  # noqa: BLE001
            pass


def tier_list(ns: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Tier entries the LOCAL daemon holds — the warm-restart recovery
    read: a replacement replica re-adverts these within one gossip beat
    of booting. ``ns=None`` returns the raw registry (full keys);
    passing a namespace (including ``""``) filters to THAT model's
    entries and strips the prefix, returning digest hex -> descriptor —
    the registry is node-global, so recovery must never adopt (and
    re-advert) entries another deployment/model published."""
    be = _backend()
    if be is None:
        with _LOCAL_TIER_LOCK:
            entries = dict(_LOCAL_TIER)
    else:
        try:
            reply = be.io.run(be.daemon.call("kv_tier_list", {}), timeout=10)
        except Exception:  # noqa: BLE001
            return {}
        if not isinstance(reply, dict):
            return {}
        entries = reply.get("entries", {})
    if ns is None:
        return entries
    if not ns:
        return {k: v for k, v in entries.items() if ":" not in k}
    prefix = f"{ns}:"
    return {
        k[len(prefix):]: v for k, v in entries.items() if k.startswith(prefix)
    }
