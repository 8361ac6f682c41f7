"""DeploymentHandle + router: replica selection per request.

Port of ``ray_tpu/serve/handle.py``. Reference analog: ``serve/handle.py`` (``DeploymentHandle:804``) and
``serve/_private/router.py`` — ``PowerOfTwoChoicesReplicaScheduler:290``:
pick two random replicas, route to the one with fewer in-flight requests.
In-flight counts are tracked client-side (each handle knows what it sent
and what completed), so the hot path makes zero control-plane calls; the
replica set refreshes when the controller version changes (long-poll
analog: cheap version check with TTL). The JAX package's trace spans
around routing belong to its tracing plane and are not ported."""

from __future__ import annotations

import random
import threading
import time

from ray_tpu_torch import api
from ray_tpu_torch.utils.exceptions import ActorError, ReplicaDiedError


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 method_name="__call__", multiplexed_model_id=None):
        self.deployment_name = deployment_name
        self._controller = controller
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._replicas: list = []
        self._version = -1
        self._checked_at = 0.0
        self._lock = threading.Lock()
        self._inflight: dict = {}    # replica -> outstanding refs
        self._tags: dict = {}        # replica -> controller replica tag
        self._model_map: dict = {}   # model id -> [replicas] (pushed)
        self._router = None          # lazy PrefixRouter
        self._router_at = 0.0

    def options(self, *, method_name: str | None = None,
                multiplexed_model_id: str | None = None
                ) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, self._controller,
                             method_name or self._method,
                             multiplexed_model_id or self._model_id)
        h._replicas, h._version = self._replicas, self._version
        h._inflight = self._inflight
        h._tags, h._model_map = self._tags, self._model_map
        h._router = self._router
        return h

    # -- replica set refresh (long-poll analog) -------------------------
    def _refresh(self, ttl: float = 0.2):
        now = time.monotonic()
        with self._lock:
            if self._replicas and now - self._checked_at < ttl:
                return
        version = api.get(self._controller.version.remote())
        with self._lock:
            if version == self._version and self._replicas:
                self._checked_at = now
                return
        version, table = api.get(
            self._controller.get_routing_table.remote(
                self.deployment_name))
        if table is None:
            raise KeyError(
                f"deployment {self.deployment_name!r} does not exist")
        replicas = [e["replica"] for e in table]
        model_map: dict = {}
        for e in table:
            for mid in e["models"]:
                model_map.setdefault(mid, []).append(e["replica"])
        with self._lock:
            old_tags = set(self._tags.values())
            self._replicas = replicas
            self._tags = {e["replica"]: e["tag"] for e in table}
            self._model_map = model_map
            self._version = version
            self._checked_at = now
            self._inflight = {r: self._inflight.get(r, []) for r in replicas}
            gone = old_tags - set(self._tags.values())
            router = self._router
        # tags the controller dropped (crash/drain) lose their prefix-
        # digest routing entries immediately — the annex TTL would keep
        # steering warm prefixes at a corpse for seconds otherwise
        if router is not None:
            for tag in gone:
                router.forget(tag)

    def _evict(self, replica):
        """Drop a failed replica from every routing structure NOW: the
        controller's reconciler takes a beat to notice the death, and
        until it bumps the version this handle's maps would happily
        re-pick the corpse (the stale-map window). The next refresh
        re-adds the replica if it was actually alive."""
        with self._lock:
            self._replicas = [r for r in self._replicas if r != replica]
            tag = self._tags.pop(replica, None)
            self._inflight.pop(replica, None)
            for mid, lst in list(self._model_map.items()):
                if replica in lst:
                    self._model_map[mid] = [
                        r for r in lst if r != replica]
            self._version = -1
        if tag is not None and self._router is not None:
            self._router.forget(tag)

    def _prune(self, replica):
        """Drop completed refs from a replica's outstanding list (non-
        blocking); returns the remaining in-flight count."""
        refs = self._inflight.get(replica, [])
        if refs:
            ready, not_ready = api.wait(refs, num_returns=len(refs),
                                            timeout=0)
            self._inflight[replica] = not_ready
            return len(not_ready)
        return 0

    def _pick(self, prefix_tokens=None):
        """Power-of-two-choices on client-side outstanding-request counts
        (pruned at pick time — no background bookkeeping threads). With a
        multiplexed model id, cache-affinity comes first: prefer replicas
        that already hold the model (reference:
        multiplexed_replica_info routing in the replica scheduler). With
        ``prefix_tokens``, prefix-cache affinity comes first: route to
        the replica whose published digest already holds the longest
        leading page run (serve/prefix_router.py), falling back to p2c
        when no digest matches."""
        if prefix_tokens is not None:
            replica = self._affinity_pick(prefix_tokens)
            if replica is not None:
                return replica
        if self._model_id is not None:
            warm = self._replicas_with_model(self._model_id)
            if warm:
                with self._lock:
                    if len(warm) == 1:
                        return warm[0]
                    a, b = random.sample(warm, 2)
                    return a if self._prune(a) <= self._prune(b) else b
        with self._lock:
            replicas = self._replicas
            if not replicas:
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no replicas")
            if len(replicas) == 1:
                return replicas[0]
            a, b = random.sample(replicas, 2)
            return a if self._prune(a) <= self._prune(b) else b

    def _replicas_with_model(self, model_id: str) -> list:
        """Replicas that currently hold model_id loaded — a LOCAL
        lookup into the controller-pushed model map (refreshed with the
        routing table on version bumps; the controller polls replicas
        off the request path, so the per-request N-round-trip sweep the
        old TTL cache amortized is gone entirely)."""
        with self._lock:
            return list(self._model_map.get(model_id, []))

    def _affinity_pick(self, tokens):
        """Prefix-affinity choice, or None for the p2c fallback. Digest
        pulls are throttled to the publish interval and best-effort: a
        replica that stops publishing just means its stale digest expires
        and every pick falls back."""
        from ray_tpu_torch.utils.config import get_config

        cfg = get_config()
        if not cfg.serve_prefix_routing_enabled:
            return None
        if self._router is None:
            from ray_tpu_torch.serve.prefix_router import PrefixRouter

            self._router = PrefixRouter()
        now = time.monotonic()
        if now - self._router_at >= cfg.serve_digest_publish_interval_s:
            self._router_at = now
            try:
                from ray_tpu_torch.serve.prefix_router import DIGEST_PREFIX
                from ray_tpu_torch.util.state import cluster_metric_annexes

                self._router.ingest(cluster_metric_annexes(
                    DIGEST_PREFIX, max_age_s=cfg.serve_digest_ttl_s))
            except Exception:  # noqa: BLE001 - best-effort: TTL expires stale
                pass
        with self._lock:
            by_tag = {t: r for r, t in self._tags.items()}
            candidates = {t: len(self._inflight.get(r, ()))
                          for t, r in by_tag.items()}
        tag = self._router.pick(tokens, candidates)
        return by_tag.get(tag) if tag is not None else None

    # -- request path ----------------------------------------------------
    def remote(self, *args, **kwargs):
        """Async call → ObjectRef (resolve with ray_tpu_torch.get). The
        reserved ``_prefix_tokens`` kwarg (the request's prompt token
        list) opts the call into prefix-affinity routing; it is stripped
        before the replica sees the arguments."""
        prefix_tokens = kwargs.pop("_prefix_tokens", None)
        if self._model_id is not None:
            from ray_tpu_torch.serve.multiplex import MODEL_ID_KWARG

            kwargs = {**kwargs, MODEL_ID_KWARG: self._model_id}
        self._refresh()
        last = None
        for attempt in range(5):
            replica = None
            try:
                replica = self._pick(prefix_tokens)  # raises in redeploy gap
                ref = replica.handle_request.remote(self._method, args,
                                                    kwargs)
                with self._lock:
                    self._inflight.setdefault(replica, []).append(ref)
                return ref
            except Exception as e:  # noqa: BLE001 - dead/empty set
                last = e
                if replica is not None:
                    self._evict(replica)
                with self._lock:
                    self._version = -1
                time.sleep(0.05 * attempt)
                self._refresh(ttl=0)
        raise ReplicaDiedError(
            deployment=self.deployment_name,
            reason=f"could not route request after 5 attempts: {last!r}")

    def stream(self, *args, **kwargs):
        """Call a GENERATOR method and iterate its chunks as they are
        produced (reference: replica handle_request_streaming:323 +
        streaming DeploymentResponse). Chunks batch over the wire
        (next_chunks) so per-chunk overhead amortizes. Stream START
        retries against a refreshed replica set like remote(); once
        streaming, a replica death surfaces to the consumer."""
        prefix_tokens = kwargs.pop("_prefix_tokens", None)
        if self._model_id is not None:
            from ray_tpu_torch.serve.multiplex import MODEL_ID_KWARG

            kwargs = {**kwargs, MODEL_ID_KWARG: self._model_id}
        self._refresh()
        last = None
        for attempt in range(5):
            replica = None
            try:
                replica = self._pick(prefix_tokens)
                stream_id = api.get(
                    replica.start_stream.remote(self._method, args,
                                                kwargs))
                break
            except Exception as e:  # noqa: BLE001 - stale/dead replica
                last = e
                if replica is not None:
                    self._evict(replica)
                with self._lock:
                    self._version = -1
                time.sleep(0.05 * attempt)
                self._refresh(ttl=0)
        else:
            raise ReplicaDiedError(
                deployment=self.deployment_name,
                reason=f"could not start stream after 5 attempts: {last!r}")

        with self._lock:
            tag = self._tags.get(replica)

        def gen():
            while True:
                try:
                    state, chunks = api.get(
                        replica.next_chunks.remote(stream_id))
                except ActorError as e:
                    # replica died mid-stream: fail the consumer fast
                    # with a typed error (a retry cannot resume a half-
                    # emitted stream) and stop routing at the corpse
                    self._evict(replica)
                    raise ReplicaDiedError(
                        tag, self.deployment_name,
                        reason=f"died mid-stream: {e!r}") from e
                yield from chunks
                if state == "end":
                    return

        return gen()

    def call(self, *args, **kwargs):
        """Sync convenience: remote + get. A replica torn down mid-request
        (redeploy/downscale) surfaces at get(); retry against the
        refreshed replica set (reference: router resend on replica death)."""
        last = None
        tag = None
        for attempt in range(3):
            ref = None
            try:
                ref = self.remote(*args, **kwargs)
                return api.get(ref)
            except ActorError as e:
                last = e
                owner = self._owner_of(ref) if ref is not None else None
                if owner is not None:
                    with self._lock:
                        tag = self._tags.get(owner, tag)
                    self._evict(owner)
                with self._lock:
                    self._version = -1
                time.sleep(0.05 * (attempt + 1))
        if isinstance(last, ReplicaDiedError):
            raise last
        raise ReplicaDiedError(
            tag, self.deployment_name,
            reason=f"call failed after 3 attempts: {last!r}") from last

    def _owner_of(self, ref):
        with self._lock:
            for r, refs in self._inflight.items():
                if ref in refs:
                    return r
        return None
