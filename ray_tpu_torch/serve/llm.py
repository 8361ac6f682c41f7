"""Continuous-batching LLM serving engine.

Port of ``ray_tpu/serve/llm.py``'s ``LLMEngine``:

- Continuous batching: a fixed-shape decode step runs over all
  ``max_batch`` cache slots; which slots are live is a mask. New requests
  are prefilled into free slots (prompts padded to a power-of-two bucket)
  while decode keeps streaming for everyone else.
- Chunked decode: ``decode_chunk`` steps per dispatch, one host read per
  chunk; a short drain chunk when a slot is about to free for a waiting
  request; continuous admission between chunk dispatches.
- Deferred first-token readback: prefill first tokens are scattered into
  a device-resident last-token vector, so the next decode chunk covers
  new slots with no host round trip; the host emits them when their copy
  lands.

JAX's asynchronous dispatch becomes launches on the current CUDA stream.
Token matrices come back through a non-blocking copy into pinned memory
and a CUDA event, so the loop keeps a chunk in flight while the previous
one is read. On the CPU every step runs synchronously and the same loop
logic holds.

``LLMDeployment`` is the serve body that hosts one engine, deployed with
``serve.run`` (``serve/api.py``) or built directly, from a zero-argument
model builder, with ``__call__`` and ``stats``. An engine built while a
thread holds a replica context (``serve/context.py``; a Serve replica
sets it) carries its deployment name and replica tag.

Every request's TTFT stages feed the metrics plane's
``ray_tpu_serve_stage_s`` histogram through handles resolved once per
engine (one lock, no RPC, no device sync on the engine thread). Not
ported: the trace spans, which belong to the tracing plane.

Threading: one engine thread owns the device loop (prefill/decode);
callers enqueue requests and read token queues.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import decoding
from ray_tpu_torch.models.decoding import KVCache
from ray_tpu_torch.util import metrics as _metrics

# Per-request TTFT decomposition (metrics plane): every request's time to
# first token splits into queue_wait (submit -> prefill dispatch),
# prefill (dispatch -> device completion, stamped by the ready watcher),
# pipeline_stall (device completion -> the loop draining the firsts) and
# ship (the host copy of the first-token batch). The four stages sum to
# the observed TTFT exactly (see Request.breakdown). Series carry the
# hosting deployment + replica tags (from the serve replica context) so
# the controller's autoscaler and the dashboard can split per
# deployment/replica; engines outside serve tag deployment="-".
_STAGES = ("queue_wait", "prefill", "pipeline_stall", "ship")
_serve_hist = _metrics.histogram(
    "ray_tpu_serve_stage_s", "per-request serve TTFT stage latency",
    tag_keys=("stage", "deployment", "replica"))


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _upload(arr, device: torch.device) -> torch.Tensor:
    """A device copy of host array ``arr``. The host array may change
    right after the call (the engine's mirrors do), so the copy is taken
    first; on CUDA it goes through pinned memory without blocking."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _HostCopy:
    """A device->host copy in flight: pinned memory plus a CUDA event on
    the card, the tensor itself on the CPU."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def wait(self):
        if self._event is not None:
            self._event.synchronize()

    def numpy(self) -> np.ndarray:
        self.wait()
        return self._host.numpy()


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                    # [P] int32
    max_new_tokens: int = 128
    temperature: float = 0.0
    eos_id: int | None = None
    # filled by the engine:
    out: "queue.Queue[int | None]" = field(default_factory=queue.Queue)
    submit_t: float = field(default_factory=time.monotonic)
    first_token_t: float | None = None
    # TTFT decomposition stamps (see Request.breakdown): prefill batch
    # dispatched / device results ready / loop drained the first-token
    # batch to the host
    dispatch_t: float | None = None
    ready_t: float | None = None
    drain_t: float | None = None
    generated: int = 0
    slot: int = -1
    # set before the None sentinel when the request itself failed
    error: BaseException | None = None
    engine: "LLMEngine | None" = None

    @property
    def ttft(self) -> float | None:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def breakdown(self) -> dict | None:
        """Measured TTFT decomposition. ``ready_t`` is clamped into
        [dispatch_t, drain_t] so the four stages always sum to the
        observed TTFT exactly."""
        if (self.first_token_t is None or self.dispatch_t is None
                or self.drain_t is None):
            return None
        ready = self.ready_t if self.ready_t is not None else self.drain_t
        ready = min(max(ready, self.dispatch_t), self.drain_t)
        return {
            "queue_wait_s": self.dispatch_t - self.submit_t,
            "prefill_s": ready - self.dispatch_t,
            "pipeline_stall_s": self.drain_t - ready,
            "ship_s": self.first_token_t - self.drain_t,
        }

    def tokens(self) -> Iterator[int]:
        """Blocking stream of generated token ids (ends on None sentinel).
        Raises the engine's error if its device loop died."""
        while True:
            tok = self.out.get()
            if tok is None:
                if self.error is not None:
                    raise self.error
                if self.engine is not None and self.engine.error is not None:
                    raise RuntimeError(
                        "LLM engine loop failed") from self.engine.error
                return
            yield tok


class LLMEngine:
    """Slot-based continuous batching over ``ray_tpu_torch.models.decoding``.
    ``params`` must lie on ``device``."""

    def __init__(self, cfg, params, *, max_batch: int = 8,
                 max_len: int = 2048, decode_chunk: int | None = None,
                 drain_chunk: int | None = None, device="cuda"):
        from ray_tpu_torch.serve.context import get_replica_context
        from ray_tpu_torch.utils.config import get_config

        _cfg = get_config()
        self.device = resolve_device(device)
        if params["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params lie on {params['embedding'].device}, engine "
                f"device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        # tokens generated per dispatch: one host read per CHUNK of decode
        # steps; admission of waiting requests happens between chunks
        if decode_chunk is None:
            decode_chunk = _cfg.serve_decode_chunk
        self.decode_chunk = max(1, decode_chunk)
        drain_flag = (drain_chunk if drain_chunk is not None
                      else _cfg.serve_drain_chunk)
        ctx = get_replica_context()
        self.deployment_name = ctx.deployment if ctx else "-"
        self.replica_tag = (ctx.replica_tag if ctx
                            else f"engine-{id(self) & 0xffffff:06x}")
        self._continuous_admission = bool(_cfg.serve_continuous_admission)
        self._window_frac = min(0.95, max(
            0.0, float(_cfg.serve_admission_window_frac)))
        self._sync_t: float | None = None       # last chunk-sync finish
        self._chunk_period: float | None = None  # EMA between syncs
        # host-side slot state
        self._lengths = np.zeros((max_batch,), np.int32)
        self._last_tok = np.zeros((max_batch,), np.int32)
        # bumped per admission into a slot: tells "same slot, same
        # request" from "same slot, NEW request" for in-flight chunks
        self._slot_gen = np.zeros((max_batch,), np.int64)
        self._active: list[Request | None] = [None] * max_batch
        self._waiting: "queue.Queue[Request]" = queue.Queue()
        self._req_ids = itertools.count()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.error: BaseException | None = None
        self._submit_lock = threading.Lock()
        self.total_generated = 0
        self.total_finished = 0
        self.ttfts: "deque[float]" = deque(maxlen=1024)
        self.breakdowns: "deque[dict]" = deque(maxlen=1024)
        # pre-resolved per-(deployment, replica) stage-histogram handles
        self._h_stage = {s: _serve_hist.handle(
            {"stage": s, "deployment": self.deployment_name,
             "replica": self.replica_tag}) for s in _STAGES}
        # ready watcher (card only): stamps Request.ready_t when a prefill
        # batch's device work completes, off the loop thread
        self._ready_q: "queue.Queue | None" = None
        self._watcher: threading.Thread | None = None
        if self.device.type == "cuda":
            self._ready_q = queue.Queue()
            self._watcher = threading.Thread(
                target=self._ready_watcher, daemon=True,
                name="llm-ready-watcher")
            self._watcher.start()
        self._dev_inputs: dict | None = None
        self._dev_dirty = True
        # device-resident last-token vector, chained through decode
        # chunks and prefill scatters
        self._last_dev: torch.Tensor | None = None
        # prefill batches whose first tokens haven't reached the host:
        # (dispatch_seq_at, items, host copy of firsts)
        self._pending_firsts: list = []
        self._dispatch_seq = 0
        self._admission_blocked = False
        self._drain_chunk = max(1, min(drain_flag, self.decode_chunk))
        self._setup_device_state()

    def _setup_device_state(self):
        """Build the KV cache (dense layout; the paged engine overrides
        this)."""
        self._cache = decoding.init_cache(self.cfg, self.max_batch,
                                          self.max_len, device=self.device)

    # -- device programs ---------------------------------------------------

    @torch.inference_mode()
    def _decode_impl(self, tokens, lengths, active, temps, *, chunk):
        """``chunk`` decode steps over every slot; returns the
        [chunk, max_batch] token matrix, the advanced lengths (kept on the
        device so chained chunks need no upload) and the merged last-token
        vector. Inactive slots are computed but masked (their position-0
        write is harmless: a later prefill overwrites it)."""
        cur, lens, toks = tokens, lengths, []
        for _ in range(chunk):
            start = torch.where(active, lens, 0)
            logits, _ = decoding.cached_forward(
                self.cfg, self.params, cur[:, None], self._cache,
                start=start, logits_mode="last")
            cur = decoding.select_tokens(logits, temps, self._gen)
            lens = torch.where(active, lens + 1, lens)
            toks.append(cur)
        toks = torch.stack(toks)
        return toks, lens, torch.where(active, toks[-1], tokens)

    @torch.inference_mode()
    def _prefill_batch_impl(self, tokens, plens, slots, temps):
        """Prefill ``n`` prompts (one bucket, padded) into cache rows
        ``slots`` and sample each row's first token. Rows are gathered,
        run as one batch-n forward, and scattered back."""
        n = tokens.shape[0]
        slots = slots.long()
        zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
        rows = KVCache(k=self._cache.k[:, slots], v=self._cache.v[:, slots],
                       lengths=zeros)
        logits, rows = decoding.cached_forward(
            self.cfg, self.params, tokens, rows, start=zeros,
            logits_mode="index", logits_idx=plens - 1)
        self._cache.k[:, slots] = rows.k
        self._cache.v[:, slots] = rows.v
        return decoding.select_tokens(logits, temps, self._gen)

    def _scatter_firsts(self, slots, firsts):
        """Last-token vector with ``firsts`` at ``slots`` (a new tensor:
        the previous one may still feed an in-flight chunk)."""
        self._last_dev = self._last_dev.index_put(
            (slots.long(),), firsts.to(self._last_dev.dtype))

    def warmup(self, prompt_len: int):
        """Run every program shape a burst at this prompt bucket can hit
        once: the batched prefill at each power-of-two group size up to
        max_batch, and both decode chunks. Call before start(). Nothing
        needs compiling here; this settles allocator and library caches
        before the first measured request."""
        bucket = min(_bucket(prompt_len), self.max_len)
        if self._last_dev is None:
            self._last_dev = _upload(self._last_tok, self.device)
        n = 1
        while n <= self.max_batch:
            slots = torch.arange(n, dtype=torch.int32, device=self.device)
            firsts = self._prefill_batch_impl(
                torch.zeros((n, bucket), dtype=torch.int32,
                            device=self.device),
                torch.ones((n,), dtype=torch.int32, device=self.device),
                slots, torch.zeros((n,), device=self.device))
            self._scatter_firsts(slots, firsts)
            _HostCopy(firsts).numpy()
            n *= 2
        self._last_dev = _upload(self._last_tok, self.device)
        zeros_i = torch.zeros((self.max_batch,), dtype=torch.int32,
                              device=self.device)
        active = torch.zeros((self.max_batch,), dtype=torch.bool,
                             device=self.device)
        for chunk in {self.decode_chunk, self._drain_chunk}:
            toks, _, _ = self._decode_call(
                chunk, zeros_i, {"lens": zeros_i, "active": active,
                                 "temps": torch.zeros((self.max_batch,),
                                                      device=self.device)})
            _HostCopy(toks).numpy()
        # warmup wrote garbage into cache rows; lengths stayed 0 and no
        # slot is active, so real admissions overwrite cleanly
        self._lengths[:] = 0
        self._last_tok[:] = 0

    # -- engine loop -------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the loop and the ready watcher and wait for both: once
        ``stop`` returns, no thread of the engine holds it, so dropping
        the engine frees its KV pool."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._watcher is not None:
            self._ready_q.put(None)
            self._watcher.join(timeout=30)

    def _ready_watcher(self):
        """Stamp ready_t per prefill batch in dispatch order (stream
        order, so sequential waits give correct stamps)."""
        while True:
            item = self._ready_q.get()
            if item is None:
                return
            copy, reqs = item
            copy.wait()
            now = time.monotonic()
            for r in reqs:
                if r.ready_t is None:
                    r.ready_t = now

    def submit(self, prompt, *, max_new_tokens: int = 128,
               temperature: float = 0.0,
               eos_id: int | None = None) -> Request:
        req = Request(
            request_id=next(self._req_ids),
            prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            eos_id=eos_id,
        )
        req.engine = self
        # pairs with the drain in _loop's finally: a request either lands
        # in _waiting before the drain or observes the dead engine here
        with self._submit_lock:
            if self.error is not None or self._stop.is_set():
                req.out.put(None)
            else:
                self._waiting.put(req)
        return req

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._active) if r is None]

    def _on_slot_retired(self, slot: int):
        """Hook: a request finished and its slot was released."""
        self._dev_dirty = True

    def _on_idle(self):
        """Hook: no active slots and nothing in flight."""

    def _reserve_slot_resources(self, req: Request, slot: int) -> bool:
        """Hook: claim per-slot resources for an admission. False =
        backpressure (requeue and stop admitting this round)."""
        return True

    def _pack_admit(self, req: Request, slot: int, plen: int) -> tuple:
        """Hook: one admit item (req, slot, plen, padded): the tokens the
        prefill must process, padded to a power-of-two bucket."""
        bucket = min(_bucket(plen), self.max_len)
        padded = np.zeros((bucket,), np.int32)
        padded[:plen] = req.prompt
        return (req, slot, plen, padded)

    def _dispatch_prefill(self, part: list, bucket: int):
        """Hook: dispatch one prefill sub-batch of (req, slot, plen,
        padded) items; returns the device first tokens."""
        dev = self.device
        return self._prefill_batch_impl(
            _upload(np.stack([it[3] for it in part]), dev),
            _upload(np.array([it[2] for it in part], np.int32), dev),
            _upload(np.array([it[1] for it in part], np.int64), dev),
            _upload(np.array([it[0].temperature for it in part],
                             np.float32), dev))

    def _admit(self, first: Request | None = None):
        """Prefill waiting requests into free slots. All prefills of the
        round are dispatched first; their first tokens reach the host
        later (_drain_firsts). ``first``: a request already pulled off the
        queue by the admission window."""
        admits = []   # (req, slot, plen, padded)
        self._admission_blocked = False
        pulled = first
        for slot in self._free_slots():
            if pulled is not None:
                req, pulled = pulled, None
            else:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    break
            plen = len(req.prompt)
            if plen >= self.max_len:
                req.error = ValueError(
                    f"prompt length {plen} >= engine max_len "
                    f"{self.max_len}")
                req.out.put(None)
                continue
            if not self._reserve_slot_resources(req, slot):
                if req.error is not None:
                    # permanently infeasible: reject (requeueing would
                    # hang it and block the queue behind it)
                    req.out.put(None)
                    continue
                self._waiting.put(req)   # backpressure: retry later
                self._admission_blocked = True
                break
            admits.append(self._pack_admit(req, slot, plen))
        if pulled is not None:
            self._waiting.put(pulled)   # no free slot took it
        if not admits:
            return
        # group by bucket, then split each group into power-of-two
        # sub-batches: one batched-prefill dispatch per sub-batch
        groups: dict[int, list] = {}
        for item in admits:
            groups.setdefault(len(item[3]), []).append(item)
        for bucket, items in groups.items():
            i = 0
            while i < len(items):
                m = 1
                while m * 2 <= len(items) - i:
                    m *= 2
                part = items[i:i + m]
                i += m
                firsts = self._dispatch_prefill(part, bucket)
                now = time.monotonic()
                for it in part:
                    it[0].dispatch_t = now
                # scatter the device firsts into the last-token vector so
                # the next decode chunk covers the new slots, and start
                # their host copy; emission waits for _drain_firsts
                slots = _upload(np.array([it[1] for it in part], np.int64),
                                self.device)
                self._scatter_firsts(slots, firsts)
                copy = _HostCopy(firsts)
                if self._ready_q is not None:
                    self._ready_q.put((copy, [it[0] for it in part]))
                else:   # CPU: the prefill has already run
                    for it in part:
                        it[0].ready_t = time.monotonic()
                for (req, slot, plen, _) in part:
                    req.slot = slot
                    self._active[slot] = req
                    # an in-flight chunk dispatched for the slot's PREVIOUS
                    # occupant must not emit to the new request
                    self._slot_gen[slot] += 1
                    self._lengths[slot] = plen
                # any chunk dispatched from here on runs after this
                # prefill on the stream
                self._pending_firsts.append(
                    (self._dispatch_seq, part, copy))
        self._dev_dirty = True   # active set / lengths changed

    def _drain_firsts(self, completed_seq: int | None = None):
        """Emit first tokens whose prefill results reached the host.
        ``completed_seq``: every prefill dispatched before the decode chunk
        with this dispatch seq is complete on the device."""
        if not self._pending_firsts:
            return
        keep = []
        for seq_at, part, copy in self._pending_firsts:
            if completed_seq is None or seq_at > completed_seq:
                keep.append((seq_at, part, copy))
                continue
            t_drain = time.monotonic()
            vals = copy.numpy()
            now = time.monotonic()
            for (req, slot, plen, _), first in zip(part, vals):
                req.drain_t = t_drain
                req.first_token_t = now
                self.ttfts.append(req.ttft)
                bd = req.breakdown
                if bd is not None:
                    self.breakdowns.append(bd)
                    if _metrics.enabled():
                        for stage in _STAGES:
                            self._h_stage[stage].observe(bd[f"{stage}_s"])
                self._emit(req, int(first))
        self._pending_firsts = keep

    def _admission_window(self) -> bool:
        """Continuous admission: between the previous chunk's sync and the
        next chunk's dispatch, wait on the queue for up to a fraction of
        the chunk period and prefill arrivals at once. Skipped until the
        loop has a period estimate, when no slot is free, or under page
        backpressure."""
        if (not self._continuous_admission or self._chunk_period is None
                or self._sync_t is None):
            return False
        deadline = self._sync_t + self._window_frac * self._chunk_period
        admitted = False
        while not self._stop.is_set():
            if self._admission_blocked or \
                    not any(r is None for r in self._active):
                break
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._waiting.get(timeout=timeout)
            except queue.Empty:
                break
            self._admit(first=req)
            admitted = True
        return admitted

    def _emit(self, req: Request, tok: int):
        req.generated += 1
        self.total_generated += 1
        self._last_tok[req.slot] = tok
        # the cache-capacity cutoff counts prompt + emitted tokens (the
        # _lengths mirror is chunk-granular, pre-advanced at dispatch)
        done = (req.eos_id is not None and tok == req.eos_id) or \
            req.generated >= req.max_new_tokens or \
            len(req.prompt) + req.generated >= self.max_len
        req.out.put(tok)
        if done:
            req.out.put(None)
            self._active[req.slot] = None
            self.total_finished += 1
            self._on_slot_retired(req.slot)

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._run_loop()
        except Exception as e:  # noqa: BLE001 - handed to every caller
            self.error = e
        finally:
            # on error and on clean stop(): every live stream and every
            # waiter gets its sentinel, under _submit_lock (see submit())
            with self._submit_lock:
                self._stop.set()
                for req in self._active:
                    if req is not None:
                        req.out.put(None)
                while True:
                    try:
                        self._waiting.get_nowait().out.put(None)
                    except queue.Empty:
                        break

    def _use_drain_chunk(self) -> bool:
        """Short decode chunks only when a waiting request could be
        admitted soon: a free slot exists (and admission is not page
        blocked), or an active request is within 3 chunks of its budget
        (the loop's generated counts lag the device by up to two in-flight
        chunks)."""
        if self._waiting.empty():
            return False
        if any(r is None for r in self._active) \
                and not self._admission_blocked:
            return True
        horizon = 3 * self.decode_chunk
        return any(
            r is not None and (r.max_new_tokens - r.generated) <= horizon
            for r in self._active)

    def _device_inputs(self, active_idx):
        """Device-resident loop inputs (active mask, temps, lengths),
        uploaded only when admission or retirement changed them."""
        if self._dev_inputs is None or self._dev_dirty:
            active = np.zeros((self.max_batch,), bool)
            active[active_idx] = True
            temps = np.array(
                [r.temperature if r is not None else 0.0
                 for r in self._active], np.float32)
            self._dev_inputs = {
                "active": _upload(active, self.device),
                "temps": _upload(temps, self.device),
                "lens": _upload(self._lengths, self.device),
            }
            self._dev_dirty = False
        return self._dev_inputs

    def _decode_call(self, chunk: int, last_tok, dev):
        """Hook: run the decode program for one chunk and return
        (token_matrix, advanced_lens, merged_last_tok); the paged engine
        overrides only this."""
        return self._decode_impl(last_tok, dev["lens"], dev["active"],
                                 dev["temps"], chunk=chunk)

    def _dispatch_decode(self, active_idx):
        """Dispatch one decode chunk (no host sync), chained off the
        device-resident last-token vector."""
        chunk = (self._drain_chunk if self._use_drain_chunk()
                 else self.decode_chunk)
        dev = self._device_inputs(active_idx)
        toks, lens, new_last = self._decode_call(chunk, self._last_dev, dev)
        self._last_dev = new_last
        dev["lens"] = lens   # stays on the device for the chained chunk
        # start the token matrix's copy to the host now: it overlaps the
        # next chunk's compute
        copy = _HostCopy(toks)
        # host mirror advances deterministically (+chunk per active slot)
        self._lengths[active_idx] += chunk
        gens = [int(self._slot_gen[i]) for i in active_idx]
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        return copy, active_idx, gens, chunk, seq

    def _emit_chunk(self, toks_np, active_idx, gens):
        for i, gen in zip(active_idx, gens):
            if self._slot_gen[i] != gen:
                continue   # slot re-admitted since dispatch: the chunk's
                # tokens belong to the retired occupant
            for t in range(toks_np.shape[0]):
                req = self._active[i]
                if req is None:
                    break   # finished mid-chunk; drop surplus tokens
                self._emit(req, int(toks_np[t, i]))

    def _run_loop(self):
        """Double-buffered decode: while chunk N's tokens copy back and are
        emitted, chunk N+1 already runs on the device. First tokens
        dispatched before chunk N are drained right after chunk N's sync,
        before the chunk's tokens, so each request's order holds."""
        pending = None   # (host copy, active_idx, gens, chunk, seq)
        self._last_dev = _upload(self._last_tok, self.device)
        while not self._stop.is_set():
            self._admit()
            active_idx = [i for i, r in enumerate(self._active)
                          if r is not None]
            if not active_idx:
                self._sync_t = None   # pipeline drains: period resets
                if pending is not None:
                    copy, idxs, gens, _, seq = pending
                    pending = None
                    toks_np = copy.numpy()
                    self._drain_firsts(completed_seq=seq)
                    self._emit_chunk(toks_np, idxs, gens)
                    continue
                if self._pending_firsts:
                    # every active request is brand-new and nothing is in
                    # flight: block for the outstanding firsts
                    self._drain_firsts(completed_seq=self._dispatch_seq)
                    continue
                self._on_idle()
                time.sleep(0.001)
                continue
            if pending is None:
                pending = self._dispatch_decode(active_idx)
                continue
            if self._admission_window():
                active_idx = [i for i, r in enumerate(self._active)
                              if r is not None]
            nxt = self._dispatch_decode(active_idx)
            copy_prev, idx_prev, gens_prev, _, _ = pending
            # every pending prefill was dispatched before nxt: emit their
            # firsts before chunk N's tokens
            self._drain_firsts(completed_seq=self._dispatch_seq)
            toks_np = copy_prev.numpy()     # chunk N host sync
            now = time.monotonic()
            if self._sync_t is not None:
                period = now - self._sync_t
                self._chunk_period = (
                    period if self._chunk_period is None
                    else 0.5 * self._chunk_period + 0.5 * period)
            self._sync_t = now
            self._emit_chunk(toks_np, idx_prev, gens_prev)
            pending = nxt

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        live = sum(r is not None for r in self._active)
        out = {
            "active_slots": live,
            "waiting": self._waiting.qsize(),
            "total_generated": self.total_generated,
            "total_finished": self.total_finished,
            "mean_ttft_s": float(np.mean(self.ttfts)) if self.ttfts else None,
        }
        if self.breakdowns:
            bs = list(self.breakdowns)
            out["ttft_breakdown_s"] = {
                k: float(np.mean([b[k] for b in bs]))
                for k in ("queue_wait_s", "prefill_s",
                          "pipeline_stall_s", "ship_s")}
            total = sum(out["ttft_breakdown_s"].values())
            if total > 0:
                out["queue_wait_share"] = (
                    out["ttft_breakdown_s"]["queue_wait_s"] / total)
        return out


class LLMDeployment:
    """Serve deployment body hosting one engine (``ray_tpu/serve/
    llm.py:906``). ``model_builder`` is a zero-argument callable returning
    ``(cfg, params)``, the parameters on the engine's device;
    ``kv_layout`` picks ``PagedLLMEngine`` ("paged") or ``LLMEngine``
    ("dense"); ``engine_kwargs`` go to the engine (``device="cpu"`` for
    the CPU: the engines default to the card). Under ``serve.run`` each
    replica builds its own engine in this process; the model builder is
    passed by reference, so replicas can share one set of weights.

        dep = serve.deployment(LLMDeployment).bind(build, max_len=2048)
        handle = serve.run(dep)
        tokens = handle.call([1, 2, 3], max_new_tokens=16)
    """

    def __init__(self, model_builder, *, max_batch: int = 8,
                 max_len: int = 2048, kv_layout: str = "paged",
                 **engine_kwargs):
        cfg, params = model_builder()
        if kv_layout == "paged":
            from ray_tpu_torch.serve.paged_llm import PagedLLMEngine

            self._engine = PagedLLMEngine(
                cfg, params, max_batch=max_batch, max_len=max_len,
                **engine_kwargs)
        elif kv_layout == "dense":
            self._engine = LLMEngine(cfg, params, max_batch=max_batch,
                                     max_len=max_len, **engine_kwargs)
        else:
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self._engine.start()

    def __call__(self, prompt, max_new_tokens: int = 128,
                 temperature: float = 0.0, eos_id: int | None = None):
        req = self._engine.submit(
            prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id)
        return list(req.tokens())

    def stats(self) -> dict:
        return self._engine.stats()
