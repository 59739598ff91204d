"""Batched serving engine: continuous batching over a fixed slot pool, with
an elastic-FIFO chunked-prefill pipeline (twin of ``repro.serve.engine``).

  * ``max_slots`` concurrent sequences share one preallocated cache whose
    batch rows are the slots; prefill runs per request (prompts padded to
    ``prefill_pad`` buckets) and writes its cache entry into the slot row.
  * decode is one ``LM.decode_step`` over the whole pool every tick,
    whatever the number of live slots; idle rows compute values nobody
    reads.
  * completion (EOS or ``max_new``) frees the slot; queued requests are
    admitted on the next tick.
  * softmax models keep each slot's KV rows in the pool (``cfg.dtype``, or
    f8 e4m3 with ``kv_dtype="f8_e4m3"``); decode writes the new row of
    every slot in place. Mamba blocks (the ssm and hybrid families) keep
    each slot's recurrent state ({"ssm" f32, "conv"}) in the pool's slot
    row, and their prompts are prefilled at their true length: a pad token
    is inert under causal attention but not in a recurrence.
  * spiking QKFormer models (``attention_kind="qk_spiking"``) keep no KV
    cache (their masks are token-local): under a packed policy each slot
    keeps its last token's masked spike map, packed, and the engine reads
    the spike telemetry off it every ``spike_stats_every`` decode ticks.

Elastic FIFOs (``prefill_chunk > 0``): each prompt is split into chunks
(rounded up to ``cfg.prefill_chunk_align``: ``ssm_chunk`` bounds for the
SSD scan) that run through ``LM.prefill_chunk``, at most
``prefill_chunks_per_tick`` a tick, so a long prompt does not freeze the
live decode slots; the result equals a blocking prefill's, except for the
moe family, whose dispatch capacity depends on the group's length (a
chunk is a group of its own). ``max_queue`` bounds the admission FIFO and a
blocking ``submit`` donates engine ticks until a place frees; sampled
tokens stream into a per-request output FIFO (``pop_output``), and with
``out_fifo_depth`` a slot whose consumer stops draining is stalled (its
cache row restored after the pool decode, its token fed again next tick)
while the others keep decoding (its rows are copied aside before the
tick and written back after it).

Self-healing: a ``FaultPlan`` (``serve.faults``) injects failures into
the tick loop. With ``integrity_every`` the engine scans, every Nth decode
tick, the decode logits, the float state rows (finite) and the packed
spike-state words (clean pad lanes) of the slot pool, as plain torch on
the device; a flagged live slot is quarantined (its rows zeroed, its
request requeued at the front and replayed from its prompt; the output
FIFO only receives tokens past those already pushed) before a token is
sampled from it. The verdict comes back to the host in the same read as
the greedy tokens, so the guard adds no wait for the device. A request
quarantined more than ``quarantine_retries`` times fails. A ``die`` event
raises ``ReplicaFailure`` for the router (``serve.router``) to fail over.

Sampling is greedy or by temperature, from the engine's own
``torch.Generator`` (seeded by ``rng_seed``; the reference draws from
``jax.random``, so the two agree only on greedy requests). The cache pool
is updated in place. The encoder-decoder family is not served (its cache
needs the source length and it has no ``prefill_chunk``, as in the
reference): it is driven directly.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from .. import ops
from ..core.events import pad_lane_mask, popcount32
from ..models.lm import param_device
from ..tree import tree_leaves, tree_map
from .faults import FaultPlan, ReplicaFailure


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission FIFO stays full (non-blocking
    submit, or a blocking submit that exhausted its tick budget)."""


class StalledEngine(RuntimeError):
    """``run_until_drained`` found work pending but no stage progressing
    for the grace window (or the tick budget ran out); ``report`` names
    the stuck slots and FIFO depths."""

    def __init__(self, msg: str, report: Optional[dict] = None):
        super().__init__(msg)
        self.report = report or {}


# Request.status lifecycle; "done" is the only success, ``done`` (the
# bool) means any of the last four.
STATUS_QUEUED = "queued"
STATUS_PREFILL = "prefill"
STATUS_DECODE = "decode"
STATUS_DONE = "done"
STATUS_CANCELLED = "cancelled"
STATUS_DEADLINE = "deadline_miss"
STATUS_FAILED = "failed"
TERMINAL = (STATUS_DONE, STATUS_CANCELLED, STATUS_DEADLINE, STATUS_FAILED)


@dataclasses.dataclass(eq=False)
class Request:
    uid: int
    prompt: np.ndarray                  # [S] int32
    max_new: int = 32
    temperature: float = 0.0            # 0 = greedy
    eos_id: Optional[int] = None
    deadline_tick: Optional[int] = None
    deadline_t: Optional[float] = None
    # -- filled by the engine --
    out: list = dataclasses.field(default_factory=list)
    fifo: deque = dataclasses.field(default_factory=deque)  # undrained tokens
    slot: int = -1
    done: bool = False
    status: str = STATUS_QUEUED
    retries: int = 0                    # quarantine evictions so far
    # tokens ever pushed to the FIFO: a quarantine replay regenerates the
    # greedy stream from the start and pushes only the tokens past this
    pushed: int = 0
    enqueued_t: float = 0.0
    first_token_t: float = 0.0
    finished_t: float = 0.0
    enqueued_tick: int = 0
    first_token_tick: int = -1


@dataclasses.dataclass
class _PrefillJob:
    """One request's in-flight chunked prefill (an elastic-FIFO entry)."""
    req: Request
    slot: int
    cache: dict                         # per-request bucket cache
    bucket: int                         # positions this job must process
    done: int = 0                       # positions processed so far
    last_logits: Optional[torch.Tensor] = None  # at the prompt's last token


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_len: int = 512
    prefill_pad: int = 64               # prompt length bucket size
    # chunked prefill: tokens a chunk (0 = blocking prefill), rounded up to
    # the family's exactness granularity (cfg.prefill_chunk_align)
    prefill_chunk: int = 0
    prefill_chunks_per_tick: int = 1    # prefill work budget per decode tick
    max_queue: int = 0                  # admission FIFO bound (0 = unbounded)
    submit_block_ticks: int = 10_000    # backpressure budget before QueueFull
    out_fifo_depth: int = 0             # per-slot output FIFO bound (0 = inf)
    # how THIS engine runs qk_spiking models, over the model config's own
    # policy (an ExecutionPolicy or a preset name; None keeps the model's)
    policy: Optional[Any] = None
    # read the packed spike telemetry every Nth decode tick (0 = never);
    # each reading waits for the device
    spike_stats_every: int = 1
    # run the integrity guard every Nth decode tick (0 = never): a scan of
    # the logits and the slot pool whose verdict is a [max_slots] bool
    # pair; a flagged live slot is quarantined instead of sampled
    integrity_every: int = 0
    # a request evicted more than this many times fails instead of
    # being requeued again
    quarantine_retries: int = 2
    deadline_ticks: int = 0             # default per-request deadline

    def __post_init__(self):
        if self.policy is not None:
            self.policy = ops.as_policy(self.policy)


def pool_leaves(layers: Any, kind: str = "kv") -> list:
    """(kind, leaf) for every leaf of a cache's layers in ``tree_leaves``
    order: "ssm" and "conv" for a mamba state's leaves, "kv" for the
    attention entries."""
    if isinstance(layers, dict):
        return [pair for k in sorted(layers)
                for pair in pool_leaves(layers[k], k if k in ("ssm", "conv")
                                        else kind)]
    if isinstance(layers, (list, tuple)):
        return [pair for v in layers for pair in pool_leaves(v, kind)]
    return [(kind, layers)]


def slot_row(kind: str, leaf: torch.Tensor, slot: int) -> torch.Tensor:
    """One slot's view of a pool leaf: the batch axis is the fourth from
    the end of a KV entry [.., B, S, H, D] and of an ssm state [.., B, H,
    P, N], the third of a conv state [.., B, K-1, C]."""
    return leaf.narrow(leaf.ndim - (3 if kind == "conv" else 4), slot, 1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Engine:
    def __init__(self, model, params: dict, cfg: EngineConfig,
                 rng_seed: int = 0, faults: Optional[FaultPlan] = None):
        if model.cfg.family == "encdec":
            raise ValueError(
                f"{model.cfg.name}: the engine serves the decoder-only LM "
                f"families; an encoder-decoder's cache needs the source "
                f"length and it has no prefill_chunk (drive EncDecLM's "
                f"prefill / decode_step directly)")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = param_device(params)
        # the fault script (None in production); its kernel faults are
        # process-global and armed now
        self.faults = faults
        if faults is not None:
            faults.arm_kernel_faults()
        spiking = model.cfg.attention_kind == "qk_spiking"
        self.policy = model.cfg.exec_policy
        if spiking:
            eff = ops.merge_engine_policy(model.cfg.exec_policy, cfg.policy)
            if eff != model.cfg.exec_policy:
                # this engine's policy without touching the caller's model
                self.model = type(model)(ops.with_policy(model.cfg, eff))
            self.policy = eff
        if cfg.prefill_chunk > 0 and not hasattr(self.model, "prefill_chunk"):
            raise ValueError(f"{type(self.model).__name__} has no "
                             f"prefill_chunk: set EngineConfig.prefill_chunk"
                             f"=0 for blocking prefill")
        self.queue: deque[Request] = deque()
        self.prefill_fifo: deque[_PrefillJob] = deque()
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.requests: dict[int, Request] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._uid = itertools.count()
        self._track_spikes = (spiking and self.policy.packed
                              and cfg.spike_stats_every > 0)
        self._spike_log: list[dict] = []
        self._tick = 0
        self._queue_hwm = 0
        self._prefill_fifo_hwm = 0
        self._out_fifo_hwm = 0
        self._stall_ticks = 0
        self._prefill_chunks = 0
        # rolling windows (host seconds around synchronised device work)
        self._tick_wall: deque = deque(maxlen=4096)
        self._prefill_wall: deque = deque(maxlen=4096)
        self._tokens_emitted = 0
        self._cancelled = 0
        self._deadline_miss = 0
        self._quarantined = 0
        self._requeues = 0
        self._failed = 0
        self._guard_scans = 0
        self._pad_masks: dict = {}          # words a row -> pad-lane mask
        self._forced_stalls: dict[int, int] = {}   # slot -> stalled until
        # the slot-pool cache; per-slot valid lengths kept on the host
        self.cache = self.model.init_cache(cfg.max_slots, cfg.max_len,
                                           device=self.device)
        self.cache["len"] = torch.zeros((), dtype=torch.int32,
                                        device=self.device)
        self.slot_len = np.zeros(cfg.max_slots, np.int64)
        self.free_slots = list(range(cfg.max_slots))

    # ------------------------------------------------------------ lifecycle
    def submit(self, prompt, max_new: int = 32, temperature: float = 0.0,
               eos_id: Optional[int] = None, block: bool = True,
               deadline_ticks: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request. With ``max_queue`` set and the admission FIFO
        full, a blocking submit donates engine ticks until a place frees;
        ``block=False`` raises ``QueueFull`` at once. ``deadline_ticks``
        (engine ticks from enqueue; None inherits the config's, 0 none)
        and ``deadline_s`` (wall seconds) bound the request's life: past
        either it is cancelled with status "deadline_miss"."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) == 0:
            raise ValueError("empty prompt: there is no position to read "
                             "first-token logits from")
        if len(prompt) >= self.cfg.max_len:
            raise ValueError(f"prompt length {len(prompt)} >= max_len "
                             f"{self.cfg.max_len}: the slot pool cannot "
                             f"hold it (raise EngineConfig.max_len)")
        if self.cfg.max_queue and len(self.queue) >= self.cfg.max_queue:
            if not block:
                raise QueueFull(f"admission FIFO at bound "
                                f"{self.cfg.max_queue}")
            for _ in range(self.cfg.submit_block_ticks):
                self.step()
                if len(self.queue) < self.cfg.max_queue:
                    break
            else:
                raise QueueFull("backpressure tick budget exhausted")
        req = Request(uid=next(self._uid), prompt=prompt, max_new=max_new,
                      temperature=temperature, eos_id=eos_id)
        req.enqueued_t = time.time()
        req.enqueued_tick = self._tick
        if deadline_ticks is None:
            deadline_ticks = self.cfg.deadline_ticks or None
        if deadline_ticks is not None:
            req.deadline_tick = self._tick + int(deadline_ticks)
        if deadline_s is not None:
            req.deadline_t = req.enqueued_t + float(deadline_s)
        self.queue.append(req)
        self.requests[req.uid] = req
        self._queue_hwm = max(self._queue_hwm, len(self.queue))
        return req.uid

    def cancel(self, uid: int, status: str = STATUS_CANCELLED) -> bool:
        """Cancel a request wherever it is: drop it from the queue, abandon
        its prefill, or free its decode slot. Tokens already emitted stay
        drainable. False for unknown or finished uids."""
        req = self.requests.get(uid)
        if req is None or req.done:
            return False
        if req in self.queue:
            self.queue.remove(req)
        for job in list(self.prefill_fifo):
            if job.req is req:
                self.prefill_fifo.remove(job)
                self._release_slot(job.slot)
        if req.slot >= 0 and self.active.get(req.slot) is req:
            del self.active[req.slot]
            self._release_slot(req.slot, scrub=self.cfg.integrity_every > 0)
        self._finish(req, status)
        if status == STATUS_CANCELLED:
            self._cancelled += 1
        return True

    def _finish(self, req: Request, status: str) -> None:
        req.done = True
        req.status = status
        req.slot = -1
        req.finished_t = time.time()
        self.finished.append(req)

    def _release_slot(self, slot: int, scrub: bool = False) -> None:
        self.slot_len[slot] = 0
        self.free_slots.append(slot)
        if scrub:
            self._scrub_slot(slot)

    def _deadline_sweep(self) -> None:
        live = list(self.queue) + [j.req for j in self.prefill_fifo] \
            + list(self.active.values())
        now = None
        for req in live:
            over = (req.deadline_tick is not None
                    and self._tick >= req.deadline_tick)
            if not over and req.deadline_t is not None:
                now = time.time() if now is None else now
                over = now >= req.deadline_t
            if over:
                self.cancel(req.uid, status=STATUS_DEADLINE)
                self._deadline_miss += 1

    def pop_output(self, uid: int) -> list[int]:
        """Drain a request's output FIFO; draining un-stalls its slot. A
        finished, drained request is retired from the uid map."""
        req = self.requests.get(uid)
        if req is None:
            return []
        out, req.fifo = list(req.fifo), deque()
        if req.done:
            del self.requests[uid]
        return out

    def load(self) -> int:
        """Requests in flight (queued, prefilling, decoding): the router's
        dispatch metric."""
        return len(self.queue) + len(self.prefill_fifo) + len(self.active)

    # ------------------------------------------------------------- admission
    def _bucket_len(self, s: int) -> int:
        if self.model.cfg.family in ("ssm", "hybrid"):
            # a recurrence integrates pad positions into its state: prefill
            # at the true length (attention pads are causal-inert)
            return s
        return min(self.cfg.max_len,
                   -(-s // self.cfg.prefill_pad) * self.cfg.prefill_pad)

    def _admit(self) -> None:
        chunked = self.cfg.prefill_chunk > 0
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self.free_slots.pop()
            req.slot = slot
            req.status = STATUS_PREFILL
            if chunked:
                self._admit_chunked(req, slot)
            else:
                self._admit_blocking(req, slot)

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.tensor(toks, dtype=torch.int64, device=self.device)

    def _admit_blocking(self, req: Request, slot: int) -> None:
        s = len(req.prompt)
        toks = np.zeros((1, self._bucket_len(s)), np.int32)
        toks[0, :s] = req.prompt        # right-pad (token-local: pads inert)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params,
                                           {"tokens": self._tokens(toks)},
                                           return_all_logits=True)
        _sync(self.device)
        self._prefill_wall.append(time.perf_counter() - t0)
        self._write_slot(slot, cache)
        self._activate(req, slot, logits[0, s - 1])

    def _admit_chunked(self, req: Request, slot: int) -> None:
        bucket = self._bucket_len(len(req.prompt))
        cache = self.model.init_cache(1, bucket, device=self.device)
        cache["len"] = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.model.cfg.kv_dtype:
            # chunk attention reads back the prefix it wrote: keep the
            # request's cache at compute precision and quantize once at
            # _write_slot, where the blocking path does
            dt = self.model.cfg.dtype
            cache["layers"] = tree_map(
                lambda a: a.to(dt) if a.dtype == torch.float8_e4m3fn else a,
                cache["layers"])
        self.prefill_fifo.append(_PrefillJob(req, slot, cache, bucket))
        self._prefill_fifo_hwm = max(self._prefill_fifo_hwm,
                                     len(self.prefill_fifo))

    def _chunk_size(self) -> int:
        align = self.model.cfg.prefill_chunk_align
        return -(-self.cfg.prefill_chunk // align) * align

    def _prefill_step(self, job: _PrefillJob) -> bool:
        """Run one chunk of one request's prefill. True when the job is
        complete (its slot written, the request live)."""
        req, s = job.req, len(job.req.prompt)
        chunk = min(self._chunk_size(), job.bucket - job.done)
        toks = np.zeros((1, chunk), np.int32)
        valid = max(0, min(chunk, s - job.done))
        toks[0, :valid] = req.prompt[job.done:job.done + valid]
        t0 = time.perf_counter()
        logits, job.cache = self.model.prefill_chunk(
            self.params, self._tokens(toks), job.cache)
        _sync(self.device)
        self._prefill_wall.append(time.perf_counter() - t0)
        self._prefill_chunks += 1
        if job.done <= s - 1 < job.done + chunk:
            job.last_logits = logits[0, s - 1 - job.done]
        job.done += chunk
        if job.done < job.bucket:
            return False
        self._write_slot(job.slot, job.cache)
        self._activate(req, job.slot, job.last_logits)
        return True

    def _emit(self, req: Request, tok: int) -> None:
        """Record one sampled token; the FIFO only receives tokens past
        ``req.pushed`` (a quarantine replay delivers nothing twice)."""
        req.out.append(tok)
        self._tokens_emitted += 1
        if len(req.out) > req.pushed:
            req.fifo.append(tok)
            req.pushed = len(req.out)
            self._out_fifo_hwm = max(self._out_fifo_hwm, len(req.fifo))

    def _activate(self, req: Request, slot: int,
                  last_logits: torch.Tensor) -> None:
        """Prefill finished: the slot goes live with its first token."""
        self.slot_len[slot] = len(req.prompt)  # only the real prompt is valid
        greedy = int(torch.argmax(last_logits)) if req.temperature <= 0 \
            else None
        self._emit(req, self._sample(last_logits, req, greedy))
        if req.first_token_tick < 0:    # a replay keeps the first TTFT
            req.first_token_t = time.time()
            req.first_token_tick = self._tick
        req.status = STATUS_DECODE
        self.active[slot] = req

    # ---------------------------------------------------------- cache moves
    def _write_slot(self, slot: int, prefill_cache: dict) -> None:
        """Copy one request's prefill cache into its slot row (in place),
        in the pool's dtype: KV rows quantized here when the pool is f8,
        a mamba state whole."""
        for (kind, pool), (_, new) in zip(
                pool_leaves(self.cache["layers"]),
                pool_leaves(prefill_cache["layers"])):
            dst = slot_row(kind, pool, slot)
            if kind == "kv":
                if new.shape[-3] == 0:      # qk_spiking: stateless
                    continue
                dst = dst.narrow(dst.ndim - 3, 0, new.shape[-3])
            dst.copy_(new.to(pool.dtype))

    def _snapshot_slots(self, slots: set) -> dict:
        """A copy of each slot's rows in every pool, taken before a decode
        that writes the pool in place."""
        return {slot: [slot_row(kind, pool, slot).clone()
                       for kind, pool in pool_leaves(self.cache["layers"])]
                for slot in slots}

    def _restore_slot(self, slot: int, saved: list) -> None:
        """Write one slot's rows back from its snapshot, so a stalled
        slot's tick leaves its state as it was."""
        for (kind, pool), prev in zip(pool_leaves(self.cache["layers"]),
                                      saved):
            slot_row(kind, pool, slot).copy_(prev)

    def _scrub_slot(self, slot: int) -> None:
        """Zero one slot's rows in every pool: a poisoned row must not
        reach the slot's next occupant (a prefill writes only its own
        positions)."""
        for kind, pool in pool_leaves(self.cache["layers"]):
            slot_row(kind, pool, slot).zero_()

    # ------------------------------------------------------ fault injection
    def _resolve_fault_slot(self, slot: int) -> Optional[int]:
        if slot >= 0:
            return slot if slot in self.active else None
        return min(self.active) if self.active else None

    def _inject_faults(self, logits: torch.Tensor) -> None:
        """Apply this tick's due state and logit faults, in place, after
        the decode and before the guard (which must see them the tick
        they land)."""
        for ev in self.faults.due(
                ("nan_logits", "nan_state", "corrupt_word"), self._tick):
            slot = self._resolve_fault_slot(ev.slot)
            if slot is None:            # no live slot yet: fire next tick
                self.faults.defer(ev)
                continue
            if ev.kind == "corrupt_word" and self._corrupt_words(slot):
                continue
            if ev.kind == "nan_state" and self._corrupt_state(slot, ev.value):
                continue
            # nan_logits, and the fallback where a family keeps no float or
            # packed per-slot state (qk_spiking under a dense policy)
            logits[slot] = ev.value

    def _corrupt_words(self, slot: int) -> bool:
        """Set a slot's last packed spike-state word to all ones, pad
        lanes included: the guard sees it where the row has pad lanes
        (n_heads * head_dim short of the 128-lane grid). False where the
        pool holds no packed words."""
        for leaf in tree_leaves(self.cache["layers"]):
            if leaf.dtype == torch.int32 and leaf.ndim == 5 and leaf.numel():
                leaf[0, slot, 0, 0, -1] = -1
                return True
        return False

    def _corrupt_state(self, slot: int, value: float) -> bool:
        """Poison one element of a slot's float state row (KV, ssm, conv).
        False where the model keeps no float per-slot state."""
        for kind, leaf in pool_leaves(self.cache["layers"]):
            if not (leaf.is_floating_point() and leaf.numel()):
                continue
            ax = leaf.ndim - (3 if kind == "conv" else 4)
            if ax < 0 or leaf.shape[ax] != self.cfg.max_slots:
                continue
            idx = [0] * leaf.ndim
            idx[ax] = slot
            leaf[tuple(idx)].copy_(torch.tensor(value).to(leaf.dtype))
            return True
        return False

    # ------------------------------------------------------ integrity guard
    def _integrity_verdict(self, logits: torch.Tensor) -> list:
        """Per-slot ``[numeric_bad, packed_bad]`` bool tensors on the
        device. Numeric: a non-finite value in the slot's logits or float
        state rows. Packed: a set bit in a packed word pool's pad lanes
        (columns >= n_heads * head_dim, zero in well-formed spike state)."""
        n = self.cfg.max_slots
        bad_num = ~torch.isfinite(logits.reshape(n, -1)).all(dim=1)
        bad_pack = torch.zeros(n, dtype=torch.bool, device=self.device)
        cfg = self.model.cfg
        d_logical = cfg.n_heads * cfg.resolved_head_dim
        for kind, leaf in pool_leaves(self.cache["layers"]):
            if not leaf.numel():
                continue
            ax = leaf.ndim - (3 if kind == "conv" else 4)
            if ax < 0 or leaf.shape[ax] != n:
                continue
            rest = tuple(d for d in range(leaf.ndim) if d != ax)
            if leaf.dtype == torch.float8_e4m3fn:   # NaN: all ones but sign
                bad_num |= ((leaf.view(torch.uint8) & 0x7F) == 0x7F).any(
                    dim=rest)
            elif leaf.is_floating_point():
                bad_num |= ~torch.isfinite(leaf).all(dim=rest)
            elif leaf.dtype == torch.int32 and leaf.ndim == 5:
                width = leaf.shape[-1]
                if width not in self._pad_masks:
                    self._pad_masks[width] = torch.from_numpy(
                        pad_lane_mask(d_logical, width)).to(self.device)
                bad_pack |= ((leaf & self._pad_masks[width]) != 0).any(
                    dim=rest)
        return [bad_num, bad_pack]

    def _quarantine(self, slot: int) -> None:
        """Evict a slot the guard flagged: zero its rows, free it, and
        requeue its request at the front to replay from its prompt (greedy
        decoding regenerates the same stream; ``pushed`` keeps the FIFO
        from delivering it twice). Past the retry budget the request
        fails."""
        req = self.active.pop(slot)
        self._release_slot(slot, scrub=True)
        self._quarantined += 1
        req.retries += 1
        if req.retries > self.cfg.quarantine_retries:
            self._finish(req, STATUS_FAILED)
            self._failed += 1
            return
        req.out = []
        req.slot = -1
        req.status = STATUS_QUEUED
        self.queue.appendleft(req)
        self._requeues += 1

    def _sample(self, logits: torch.Tensor, req: Request,
                greedy: Optional[int]) -> int:
        if req.temperature <= 0.0:
            return greedy
        probs = torch.softmax(logits.to(torch.float32) / req.temperature,
                              dim=-1)
        return int(torch.multinomial(probs, 1, generator=self._gen))

    # ------------------------------------------------------------------ tick
    def _stalled_slots(self) -> set:
        stalled = set()
        if self.faults is not None:
            for ev in self.faults.due("stall_consumer", self._tick):
                slot = self._resolve_fault_slot(ev.slot)
                if slot is None:
                    self.faults.defer(ev)
                    continue
                self._forced_stalls[slot] = self._tick + max(ev.ticks, 1)
        if self._forced_stalls:
            self._forced_stalls = {
                s: until for s, until in self._forced_stalls.items()
                if self._tick < until and s in self.active}
            stalled |= set(self._forced_stalls)
        if self.cfg.out_fifo_depth:
            stalled |= {slot for slot, req in self.active.items()
                        if len(req.fifo) >= self.cfg.out_fifo_depth}
        return stalled

    def step(self) -> int:
        """One engine tick: admit, run up to ``prefill_chunks_per_tick``
        prefill chunks, then one pool decode for all live, un-stalled
        slots. Returns the number of live sequences."""
        if self.faults is not None and self.faults.die_due(self._tick):
            raise ReplicaFailure(
                f"injected replica death at tick {self._tick}")
        self._deadline_sweep()
        self._admit()
        if self.cfg.prefill_chunk > 0:
            budget = max(1, self.cfg.prefill_chunks_per_tick)
            while budget > 0 and self.prefill_fifo:
                if self._prefill_step(self.prefill_fifo[0]):
                    self.prefill_fifo.popleft()
                budget -= 1
        if not self.active:
            return 0
        stalled = self._stalled_slots()
        self._tick += 1
        if stalled and len(stalled) == len(self.active):
            self._stall_ticks += 1
            return len(self.active)     # every consumer is backed up
        toks = np.zeros((self.cfg.max_slots, 1), np.int32)
        for slot, req in self.active.items():
            toks[slot, 0] = req.out[-1]
        # per-slot length vector: every slot sees exactly its own prefix
        self.cache["len"] = torch.tensor(self.slot_len, dtype=torch.int32,
                                         device=self.device)
        saved = self._snapshot_slots(stalled)
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.params, self._tokens(toks), self.cache)
        if self.faults is not None:
            # injected corruption lands after the decode and before the
            # guard, which must catch it before a token is sampled from it
            self._inject_faults(logits)
        greedy = torch.argmax(logits, dim=-1)
        guard = (self.cfg.integrity_every > 0
                 and self._tick % self.cfg.integrity_every == 0)
        # the tick's one read, which waits for the tick: with the guard on,
        # the greedy tokens and its verdict come back together
        if guard:
            self._guard_scans += 1
            rows = [greedy] + self._integrity_verdict(logits)
            greedy, *verdict = torch.stack(
                [r.to(torch.int64) for r in rows]).tolist()
        else:
            greedy = greedy.tolist()
        self._tick_wall.append(time.perf_counter() - t0)
        bad = ({s for s in self.active if verdict[0][s] or verdict[1][s]}
               if guard else set())
        if self._track_spikes and self._tick % self.cfg.spike_stats_every == 0:
            self._record_spike_step(sorted(self.active.keys()))
        if stalled:
            self._stall_ticks += 1
            for slot in stalled:
                # greedy: the state rolls back and the same token is fed
                # again next tick, once the FIFO drains
                self._restore_slot(slot, saved[slot])
        for slot in sorted(bad):
            # quarantine before sampling: no token leaves a poisoned slot
            self._quarantine(slot)
        done_slots = []
        for slot, req in list(self.active.items()):
            if slot in stalled:
                continue
            tok = self._sample(logits[slot], req, greedy[slot])
            self._emit(req, tok)
            self.slot_len[slot] += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.out) >= req.max_new \
                    or self.slot_len[slot] >= self.cfg.max_len - 1:
                self._finish(req, STATUS_DONE)
                done_slots.append(slot)
        for slot in done_slots:
            del self.active[slot]
            self.slot_len[slot] = 0
            self.free_slots.append(slot)
        return len(self.active)

    def pending(self) -> bool:
        """True while any stage still holds work (the drain predicate)."""
        return bool(self.active or self.queue or self.prefill_fifo)

    def _progress_signature(self) -> tuple:
        return (self._tokens_emitted, self._prefill_chunks,
                len(self.finished), len(self.queue),
                len(self.prefill_fifo))

    def _stall_report(self) -> dict:
        return {
            "tick": self._tick,
            "queued": len(self.queue),
            "prefilling": [j.req.uid for j in self.prefill_fifo],
            "stuck_slots": {
                slot: {"uid": req.uid, "out_fifo": len(req.fifo),
                       "tokens": len(req.out), "status": req.status}
                for slot, req in sorted(self.active.items())},
            "free_slots": len(self.free_slots),
        }

    def run_until_drained(self, max_ticks: int = 10_000,
                          stall_grace: int = 200) -> list[Request]:
        """Tick until every request is terminal. Raises ``StalledEngine``
        when work is pending and no stage progressed for ``stall_grace``
        ticks, or ``max_ticks`` ran out."""
        last, idle = None, 0
        for _ in range(max_ticks):
            self.step()
            if not self.pending():
                return self.finished
            sig = self._progress_signature()
            if sig == last:
                idle += 1
                if idle >= stall_grace:
                    rep = self._stall_report()
                    raise StalledEngine(
                        f"no progress for {idle} ticks with work pending: "
                        f"stuck slots {sorted(rep['stuck_slots'])}, "
                        f"{rep['queued']} queued, "
                        f"{len(rep['prefilling'])} prefilling "
                        f"(are the output FIFOs being drained?)", rep)
            else:
                last, idle = sig, 0
        rep = self._stall_report()
        raise StalledEngine(
            f"max_ticks={max_ticks} exhausted with work still pending: "
            f"stuck slots {sorted(rep['stuck_slots'])}, "
            f"{rep['queued']} queued", rep)

    def _record_spike_step(self, live_slots: list) -> None:
        """One decode tick's spike activity, read off the packed per-slot
        spike state in the pool: the popcount of the words is the spike
        count (pad lanes are zero), their bytes what crossed device memory
        for the state. The block-active and word-occupancy fractions feed
        the autotuner's sparsity hint."""
        if not live_slots:
            return
        cfg = self.model.cfg
        n_units = cfg.n_heads * cfg.resolved_head_dim
        idx = torch.tensor(live_slots, device=self.device)
        sums, packed_b, units, blk_groups = [], 0, 0, 0
        for leaf in tree_leaves(self.cache["layers"]):
            if leaf.dtype != torch.int32 or leaf.ndim != 5:
                continue                    # only the packed word pools
            sel = leaf.index_select(1, idx)
            packed_b += sel.numel() * 4
            units += sel.shape[0] * len(live_slots) * n_units
            nz = (sel != 0).reshape(-1, sel.shape[-1])
            # 128-column (4-word) metadata blocks: the k granularity of
            # the gated kernels' vld / occ maps
            wpb = min(4, nz.shape[-1])
            g = nz.shape[-1] // wpb
            grp = nz[:, :g * wpb].reshape(-1, g, wpb)
            any_blk = grp.any(dim=-1)
            blk_groups += any_blk.numel()
            sums.append(torch.stack([
                popcount32(sel).sum(), any_blk.sum(), grp.sum(),
                wpb * any_blk.sum()]))
        if not units:
            return
        spikes, blk_active, occ_words, nz_words = (
            torch.stack(sums).sum(dim=0).tolist())
        entry = {"live": len(live_slots),
                 "spike_rate": spikes / units,
                 "packed_bytes": packed_b,
                 "dense_bytes": units}          # the int8 maps it replaces
        if blk_groups:
            from ..ops.autotune import get_tuner

            active = blk_active / blk_groups
            occ = occ_words / max(nz_words, 1)
            entry["block_active_frac"] = active
            entry["word_occ_frac"] = occ
            get_tuner().observe(active, occ)
        self._spike_log.append(entry)

    def stats(self) -> dict:
        if not self.finished:
            return {}
        done = [r for r in self.finished if r.status == STATUS_DONE]
        ttft = [r.first_token_t - r.enqueued_t for r in done]
        lat = [r.finished_t - r.enqueued_t for r in done]
        toks = sum(len(r.out) for r in done)
        span = (max(r.finished_t for r in done)
                - min(r.enqueued_t for r in done)) if done else 0.0
        out = {"n": len(done),
               "n_terminal": len(self.finished),
               "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
               "latency_mean_s": float(np.mean(lat)) if lat else 0.0,
               "tokens": toks,
               "tok_per_s": toks / max(span, 1e-9),
               "queue_depth": len(self.queue),
               "active": len(self.active),
               "policy": self.policy.name,
               "spike_format": self.policy.format,
               "device": str(self.device),
               "ticks": self._tick,
               "cancelled": self._cancelled,
               "deadline_miss": self._deadline_miss,
               "quarantined": self._quarantined,
               "requeues": self._requeues,
               "failed": self._failed,
               "guard_scans": self._guard_scans,
               "prefill_mode": ("chunked" if self.cfg.prefill_chunk > 0
                                else "blocking"),
               "prefill_chunks": self._prefill_chunks,
               "queue_hwm": self._queue_hwm,
               "prefill_fifo_hwm": self._prefill_fifo_hwm,
               "out_fifo_hwm": self._out_fifo_hwm,
               "stall_ticks": self._stall_ticks}
        if self._tick_wall:
            tw = np.asarray(self._tick_wall)
            out.update({
                "decode_ticks": len(tw),
                "decode_tick_p50_s": float(np.percentile(tw, 50)),
                "decode_tick_p99_s": float(np.percentile(tw, 99)),
                "decode_tick_max_s": float(tw.max())})
        if self._prefill_wall:
            pw = np.asarray(self._prefill_wall)
            out.update({"prefill_calls": len(pw),
                        "prefill_call_p50_s": float(np.percentile(pw, 50))})
        if self._spike_log:
            log = self._spike_log
            rate = float(np.mean([e["spike_rate"] for e in log]))
            pb = float(np.mean([e["packed_bytes"] for e in log]))
            db = float(np.mean([e["dense_bytes"] for e in log]))
            out.update({
                "decode_ticks_measured": len(log),
                "spike_rate_mean": rate,
                "spike_sparsity_mean": 1.0 - rate,
                "packed_spike_bytes_per_tick_mean": pb,
                "dense_spike_bytes_per_tick_mean": db,
                "spike_state_hbm_reduction": db / max(pb, 1e-9)})
            af = [e["block_active_frac"] for e in log
                  if "block_active_frac" in e]
            if af:
                out["block_active_frac_mean"] = float(np.mean(af))
        from ..ops import fallback
        from ..ops.autotune import get_tuner

        out["autotune"] = get_tuner().snapshot()
        # fused -> reference demotions (process-global: ops.fallback)
        out["kernel_demotions"] = fallback.demotions()
        if self.faults is not None:
            out["fault_plan"] = self.faults.summary()
        return out
