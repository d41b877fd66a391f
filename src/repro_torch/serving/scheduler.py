"""Continuous-batching scheduler: admits queued requests into free engine
slots, steps the whole batch, retires finished sequences (port of
``repro.serving.scheduler``).

Host-side orchestration only — every device-side op is an Engine call.
Sampling draws from a ``torch.Generator`` the scheduler owns (seeded by
``seed``), so a run is a function of its inputs and that seed.

Paged engines change the admission contract: a request is admitted when a
*slot* is free AND the block pool can hold its prompt (prefix-cache hits
discounted) — batch size is bounded by tokens actually resident, not by
n_slots × worst-case capacity.  When the pool runs dry mid-decode (a
running request needs a fresh tail block and none is free), the scheduler
**preempts** the youngest running request: its blocks are freed and it is
re-queued at the head with its generated tokens folded into the prompt,
so the re-admission prefill recomputes the identical continuation (greedy
decoding: identical outputs with or without preemption).

Chunked prefill (``chunk_tokens=N``): instead
of running one whole-prompt prefill inside ``_admit`` — stalling every
in-flight decode for its duration — each step spends at most ``N`` prompt
tokens on ONE chunk of the in-flight admission, then runs the batched
decode step for everything resident.  Paged admission needs only the
first chunk's blocks (the quantum loop grows the allocation), and a
half-prefilled request whose next chunk finds the pool dry aborts itself
back to the queue head: its completed chunks are hash-registered, so the
re-admission resumes from the completed-chunk boundary, not token 0.
Outputs equal monolithic admission's under greedy sampling.  The stepwise
``start``/``submit``/``step`` API drives the same machinery from an arrival
trace.

Fault tolerance: every request
leaves through exactly one structured :class:`~repro_torch.serving.health.RequestOutcome`
(``finished | rejected | cancelled | deadline_exceeded | quarantined``);
deadlines run on the scheduler's virtual-token clock (1 unit per prompt
token prefilled or token decoded); a per-step NaN/Inf watchdog
quarantines poisoned slots without touching the rest of the batch; and
under pool pressure the scheduler walks the engine's budget-degradation
ladder (downshift retrieval budget + shed middle blocks) before falling
back to preemption.  The fault injector that drives all of this in the
JAX package's chaos tests is not ported yet (ROADMAP Queue 1 item 8):
``injector`` must be None.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.obs.tracing import PID_REQUEST

from . import engine as engine_mod
from .health import HealthMonitor, RequestOutcome, ServeResult, StepReport, nonfinite_slots


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]               # prompt
    max_new: int = 32
    eos: int | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False          # prompt longer than engine capacity
    # virtual-token-clock deadline (absolute; None = no deadline): the
    # request is retired `deadline_exceeded` at the first step where the
    # scheduler clock has passed it — queued, mid-prefill, or decoding
    deadline: float | None = None
    outcome: RequestOutcome | None = None   # terminal record, set at retirement
    # livelock detection (self-preemption without progress): consecutive
    # self-preemptions and the progress marker at the last one
    self_preempts: int = 0
    preempt_progress: int = -1
    # virtual-clock submission time, recorded by ContinuousScheduler.submit
    # (trace-driven callers may pass an explicit arrival) — anchors the
    # request's queued/lifetime spans and TTFT
    arrival: float | None = None


@dataclasses.dataclass
class _ChunkState:
    """An in-flight chunked admission (at most one at a time)."""

    req: Request
    slot: int
    toks: np.ndarray                # full re-admission prompt (prompt + out)
    pos: int                        # completed-chunk boundary (next start)


class ContinuousScheduler:
    def __init__(
        self,
        engine,
        params,
        pad_prompt_to: int | None = None,
        seed: int = 0,
        chunk_tokens: int | None = None,
        injector=None,
        audit_every: int | None = None,
        self_preempt_limit: int = 4,
        watchdog: bool = True,
    ):
        if injector is not None:
            raise NotImplementedError(
                "the serving fault injector is not ported yet (ROADMAP Queue 1 item 8)"
            )
        self.engine = engine
        self.params = params
        self.pad = pad_prompt_to
        # fault tolerance: allocator-audit cadence, livelock retirement
        # threshold, and the per-step non-finite-logits watchdog
        self.health = HealthMonitor(audit_every)
        self.self_preempt_limit = self_preempt_limit
        self.watchdog = watchdog
        self.vtime = 0.0                        # virtual-token clock
        # observability: the scheduler shares the engine's bundle and owns
        # the tracer's clock (spans/events land on this vtime).  Tokens
        # produced during a step are buffered and stamped once at the
        # step's *final* vtime — the clock semantics TTFT/ITL are derived
        # from.
        self.obs = engine.obs
        self.obs.tracer.set_clock(lambda: self.vtime)
        if engine.paged:
            # the prefix trie's park timestamps ride the same virtual clock:
            # deterministic functions of the trace, not of wall time
            engine.set_pool_clock(lambda: self.vtime)
        self._step_tokens: list[tuple[int, int]] = []   # (rid, token)
        self.outcomes: dict[int, RequestOutcome] = {}
        self._step_retired: list[RequestOutcome] = []
        # chunked prefill: per-step token quantum.  None keeps monolithic
        # admission (whole-prompt prefill inside _admit); an int admits
        # through Engine.begin_chunked/prefill_chunk, spending at most
        # `chunk_tokens` prompt tokens per step before the batched decode
        # step — one long admission no longer stalls every in-flight
        # decode for its whole prefill
        self.chunk_tokens = chunk_tokens
        self.free = list(range(engine.n_slots))
        self.running: dict[int, Request] = {}   # slot → request, admission order
        self.steps = 0
        self.occupancy: list[int] = []
        self.preemptions = 0
        self.prefill_chunks = 0                 # chunked-mode: chunks run
        self.prefill_aborts = 0                 # chunked-mode: mid-prefill preemptions
        self.insert_retries = 0                 # transient insert-time pool failures
        # stepwise session state (run() drives these; trace-driven callers
        # use start()/submit()/step() directly)
        self._queue: deque[Request] = deque()
        self._cache = None
        self._cur = np.zeros((engine.n_slots,), np.int32)
        self._prefilling: _ChunkState | None = None
        # sampling generator: every sampled token — the prefill-produced
        # first token included — draws from this one stream
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)

    def _sample(self, logits) -> int:
        return int(engine_mod.sample_token(logits, self.engine.sampling, self._gen)[0])

    def _release(self, cache, slot: int):
        if self.engine.paged:
            cache = self.engine.release_slot(cache, slot)
        self.free.append(slot)
        return cache

    # --------------------------------------------------- request lifecycle
    def _retire(
        self, req: Request, status: str, reason: str = "",
        slot: int | None = None,
    ) -> RequestOutcome:
        """Record a request's terminal outcome (bookkeeping only — the
        caller releases slots/blocks at its own call site, since cache
        threading differs per path).  ``slot`` is the decode slot the
        request held at retirement (None when queued / prefilling), kept
        on the outcome so chaos-lane failures are diagnosable from the
        artifact alone."""
        req.done = True
        if status == "rejected":
            req.rejected = True
        oc = RequestOutcome(
            rid=req.rid, status=status, reason=reason,
            tokens=len(req.out), vtime=self.vtime, slot=slot,
        )
        req.outcome = oc
        self.outcomes[req.rid] = oc
        self.health.record(oc)
        self._step_retired.append(oc)
        if self.obs.enabled:
            tr = self.obs.tracer
            tr.instant(
                "retired", pid=PID_REQUEST, tid=req.rid, cat="lifecycle",
                status=status, reason=reason, slot=slot,
                tokens=len(req.out))
            if req.arrival is not None:
                tr.complete(
                    "request", req.arrival, self.vtime - req.arrival,
                    pid=PID_REQUEST, tid=req.rid, cat="lifecycle",
                    status=status)
            self.obs.metrics.counter(
                "requests_retired_total", "terminal request outcomes",
            ).inc(status=status)
        return oc

    def slot_of(self, rid: int) -> int | None:
        """The decode slot currently holding request ``rid`` (None when
        queued / prefilling / retired)."""
        for s, r in self.running.items():
            if r.rid == rid:
                return s
        return None

    def cancel(self, rid: int, reason: str = "cancelled by caller") -> bool:
        """Withdraw a request wherever it is — queued, mid-chunked-prefill,
        or mid-decode — releasing its blocks and recording a ``cancelled``
        outcome.  False when ``rid`` is unknown or already retired."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                self._retire(r, "cancelled", reason)
                return True
        st = self._prefilling
        if st is not None and st.req.rid == rid:
            self._cache = self.engine.abort_chunked(self._cache, st.slot)
            self.free.append(st.slot)
            self._prefilling = None
            self._retire(st.req, "cancelled", reason, slot=st.slot)
            return True
        slot = self.slot_of(rid)
        if slot is not None:
            req = self.running.pop(slot)
            self._cache = self._release(self._cache, slot)
            self._retire(req, "cancelled", reason, slot=slot)
            return True
        return False

    def _expire_deadlines(self) -> bool:
        """Retire every request whose virtual-token deadline has passed —
        in the queue, mid-chunked-prefill, and mid-decode."""
        any_expired = False
        for r in [
            r for r in self._queue
            if r.deadline is not None and self.vtime >= r.deadline
        ]:
            self._queue.remove(r)
            self._retire(r, "deadline_exceeded", "expired while queued")
            any_expired = True
        st = self._prefilling
        if st is not None and st.req.deadline is not None and self.vtime >= st.req.deadline:
            self._cache = self.engine.abort_chunked(self._cache, st.slot)
            self.free.append(st.slot)
            self._prefilling = None
            self._retire(
                st.req, "deadline_exceeded", "expired mid-chunked-prefill",
                slot=st.slot,
            )
            any_expired = True
        for slot, req in list(self.running.items()):
            if req.deadline is not None and self.vtime >= req.deadline:
                del self.running[slot]
                self._cache = self._release(self._cache, slot)
                self._retire(
                    req, "deadline_exceeded", "expired mid-decode", slot=slot
                )
                any_expired = True
        return any_expired

    def _note_self_preempt(self, req: Request, marker: int) -> bool:
        """Track consecutive self-preemptions without progress.  ``marker``
        is a monotone progress measure (tokens resident / completed-chunk
        boundary); a self-preemption that didn't advance it extends the
        streak.  True → the request is livelocked and should be retired."""
        if marker <= req.preempt_progress:
            req.self_preempts += 1
        else:
            req.self_preempts = 1
            req.preempt_progress = marker
        return req.self_preempts >= self.self_preempt_limit

    def _try_degrade(self, cache):
        """One rung down the budget-degradation ladder: halve the engine's
        retrieval budget and shed running slots' middle blocks (the sink
        and recent-window blocks the guard-rails read exactly are kept).
        Returns (freed any blocks?, cache) — False sends the caller to
        the preemption fallback (ladder floor reached / nothing to shed).
        """
        eng = self.engine
        if not (eng.paged and eng.degradable):
            return False, cache
        if not eng.downshift_budget():
            return False, cache
        freed = 0
        for slot in self.running:
            n, cache = eng.shed_middle_blocks(cache, slot)
            freed += n
        return freed > 0, cache

    def _reject_inadmissible(self, req: Request, toks_list) -> bool:
        """Structured rejection of requests that can never be served: a
        prompt beyond the cache capacity (a longer prompt would write out
        of range — the slab path's dynamic_update_slice silently clamps
        onto live rows), or, paged, a prompt needing more blocks than the
        whole pool owns (admitting it would only livelock the
        preempt/re-admit cycle).  The warning stays for humans; callers
        branch on the outcome record."""
        eng = self.engine
        if len(toks_list) > eng.capacity:
            msg = (
                f"request {req.rid}: prompt of {len(toks_list)} tokens "
                f"exceeds engine capacity {eng.capacity}; rejected"
            )
            warnings.warn(msg)
            self._retire(req, "rejected", msg)
            return True
        if (
            eng.paged
            and -(-len(toks_list) // eng.block_size) > eng.allocator.usable
        ):
            msg = (
                f"request {req.rid}: prompt of {len(toks_list)} tokens needs "
                f"more blocks than the whole pool holds "
                f"({eng.allocator.usable} usable × {eng.block_size}); rejected"
            )
            warnings.warn(msg)
            self._retire(req, "rejected", msg)
            return True
        return False

    def _admit(self, queue: deque[Request], cache, cur_tokens):
        skipped: list[Request] = []
        while queue and self.free:
            req = queue.popleft()
            # preempted requests carry their generated tokens: the
            # re-admission prompt is prompt + out so prefill recomputes
            # the cache the preemption dropped
            toks_list = req.tokens + req.out
            if self._reject_inadmissible(req, toks_list):
                continue
            if (
                self.engine.paged
                and self.engine.blocks_needed(toks_list) > self.engine.free_blocks
            ):
                # pool full for THIS prompt: scan ahead — a later, smaller
                # request may fit the remaining blocks (the old `break`
                # head-of-line-blocked the whole queue on the big head even
                # with slots and blocks to spare).  Skipped requests go
                # back to the head in arrival order below.
                skipped.append(req)
                continue
            slot = self.free.pop()
            toks = np.asarray(toks_list, np.int32)
            S = self.pad or len(toks)
            S = max(S, len(toks))
            padded = np.zeros((1, S), np.int32)
            padded[0, : len(toks)] = toks
            try:
                logits, cache = self.engine.insert(
                    self.params, cache,
                    torch.from_numpy(padded).to(self.engine.device), len(toks), slot,
                )
            except engine_mod.PoolExhausted:
                # the pool dried between the admission check and the
                # allocation (transient: a fault-injected failure burst, or
                # an admission-check race).  The insert rolled itself back;
                # re-queue and retry on a later sweep (the retry counts as
                # step progress — transient failures drain over steps).
                self.free.append(slot)
                skipped.append(req)
                self.insert_retries += 1
                continue
            if self.obs.enabled:
                self._trace_admission_start(req)
                self.obs.tracer.complete(
                    "prefill", self.vtime, len(toks), pid=PID_REQUEST,
                    tid=req.rid, cat="prefill", slot=slot, tokens=len(toks))
            self.vtime += len(toks)
            first = self._sample(logits)
            req.out.append(first)
            self._step_tokens.append((req.rid, first))
            # the prefill-produced token counts: check termination before
            # the slot ever decodes.  at_capacity: a full-capacity prompt
            # has nowhere to write the next token's KV — retire now rather
            # than let the first decode step write out of range
            at_capacity = (
                len(req.tokens) + len(req.out) - 1 >= self.engine.capacity
            )
            if (
                len(req.out) >= req.max_new
                or (req.eos is not None and first == req.eos)
                or at_capacity
            ):
                self._retire(req, "finished", slot=slot)
                cache = self._release(cache, slot)
                continue
            cur_tokens[slot] = first
            self.running[slot] = req
        for r in reversed(skipped):
            queue.appendleft(r)
        return cache

    def _preempt_youngest(
        self, queue: deque[Request], cache, requester: int | None = None
    ) -> tuple[int, dict]:
        """Free the most recently admitted running request and push it
        back to the queue head (its generated tokens become prompt suffix
        on re-admission).  Returns (victim slot, cache).

        ``requester`` is the slot whose dry append triggered this: when
        the victim IS the requester (self-preemption), the cycle makes
        no one else any room — a repeat without progress is the classic
        lone-request livelock, and after ``self_preempt_limit`` such
        cycles the request is retired ``rejected`` instead of re-queued.
        """
        slot = next(reversed(self.running))
        req = self.running.pop(slot)
        cache = self._release(cache, slot)
        self.preemptions += 1
        reason = (
            "self-preemption (own dry append)" if slot == requester
            else f"preempted for slot {requester} (pool dry)"
        )
        self.health.record_event(
            "preempt", slot=slot, rid=req.rid, reason=reason,
            requester=requester,
        )
        if self.obs.enabled:
            self.obs.tracer.instant(
                "preempt", cat="preemption", slot=slot, rid=req.rid,
                requester=requester)
            self.obs.metrics.counter(
                "preemptions_total", "running requests evicted for space",
            ).inc()
        if slot == requester and self._note_self_preempt(
            req, len(req.tokens) + len(req.out)
        ):
            self.health.self_preempt_retires += 1
            msg = (
                f"request {req.rid}: {req.self_preempts} consecutive "
                f"self-preemptions without progress (decode outgrows the "
                f"block pool); retired"
            )
            warnings.warn(msg)
            self._retire(req, "rejected", msg, slot=slot)
        else:
            queue.appendleft(req)
        return slot, cache

    def _ensure_append_capacity(self, queue: deque[Request], cache):
        """Paged: every running slot must own a writable tail block before
        the decode step (fresh block on a boundary, copy-on-write on a
        shared tail).  When the pool is dry, walk the degradation ladder
        first — downshift the retrieval budget and shed middle blocks of
        running slots — and only preempt youngest-first once the ladder
        floor is reached or shedding frees nothing."""
        for slot in list(self.running):
            while slot in self.running:
                ok, cache = self.engine.advance_slot(cache, slot)
                if ok:
                    break
                degraded, cache = self._try_degrade(cache)
                if degraded:
                    continue  # freed blocks — retry the append
                victim, cache = self._preempt_youngest(queue, cache, requester=slot)
                # if the dry slot itself was youngest, it is preempted
                # and the loop guard exits; it re-admits from the queue
        return cache

    # ------------------------------------------------------ stepwise protocol
    def start(self):
        """(Re)initialise a stepwise serving session: fresh engine cache,
        empty queue, all slots free.  ``run()`` calls this; trace-driven
        callers (benchmarks/bench_serve_trace.py) use
        ``start()`` + ``submit()`` + ``step()`` directly."""
        self.free = list(range(self.engine.n_slots))
        self.running = {}
        self._queue = deque()
        self._cache = self.engine.new_cache()
        self._cur = np.zeros((self.engine.n_slots,), np.int32)
        self._prefilling = None
        self.vtime = 0.0
        self.outcomes = {}
        self._step_retired = []
        self.health = HealthMonitor(self.health.audit_every)
        self._step_tokens = []
        # one session, one trace: vtime restarts at 0, so a carried-over
        # event buffer would be non-monotone
        self.obs.tracer.reset()

    def submit(self, req: Request, arrival: float | None = None):
        """Enqueue a request (FIFO admission order).  ``arrival`` pins the
        request's virtual-clock submission time (default: now) — the
        anchor of its queued span and TTFT."""
        req.arrival = self.vtime if arrival is None else float(arrival)
        self._queue.append(req)
        if self.obs.enabled:
            self.obs.tracer.instant(
                "submitted", ts=req.arrival, pid=PID_REQUEST, tid=req.rid,
                cat="lifecycle", prompt_tokens=len(req.tokens),
                max_new=req.max_new)

    def idle_until(self, t: float) -> None:
        """Advance the virtual clock to ``t`` (no-op when already past) —
        trace replay uses this to model idle gaps between arrivals."""
        self.vtime = max(self.vtime, float(t))

    @property
    def busy(self) -> bool:
        """Work left: anything running, queued, or mid-chunked-prefill."""
        return bool(self.running or self._queue or self._prefilling)

    def _trace_admission_start(self, req: Request) -> None:
        """Close the request's queued span at the moment it leaves the
        queue (monolithic admission, chunked open, or prefix replay)."""
        if req.arrival is not None:
            self.obs.tracer.complete(
                "queued", req.arrival, self.vtime - req.arrival,
                pid=PID_REQUEST, tid=req.rid, cat="lifecycle")

    def _finish_admission(self, req: Request, slot: int, logits):
        """Sample the prefill-produced first token, then either retire the
        request right away (max_new / eos / at-capacity) or mark the slot
        running — the same contract as the tail of ``_admit``."""
        first = self._sample(logits)
        req.out.append(first)
        self._step_tokens.append((req.rid, first))
        at_capacity = len(req.tokens) + len(req.out) - 1 >= self.engine.capacity
        if (
            len(req.out) >= req.max_new
            or (req.eos is not None and first == req.eos)
            or at_capacity
        ):
            self._retire(req, "finished", slot=slot)
            self._cache = self._release(self._cache, slot)
        else:
            self._cur[slot] = first
            self.running[slot] = req

    def _start_chunked_admission(self) -> bool:
        """Pop the first admissible queued request and open its chunked
        insertion (paged: admitted on *first-chunk* blocks — the quantum
        loop grows the allocation).  Full-prompt prefix hits replay with
        zero prefill FLOPs and keep scanning.  Returns True if anything
        was admitted/replayed/rejected."""
        eng = self.engine
        q = self._queue
        progressed = False
        skipped: list[Request] = []
        while q and self.free and self._prefilling is None:
            req = q.popleft()
            toks_list = req.tokens + req.out
            if self._reject_inadmissible(req, toks_list):
                progressed = True
                continue
            if eng.paged:
                if (
                    eng.blocks_needed_chunk(toks_list, self.chunk_tokens)
                    > eng.free_blocks
                ):
                    skipped.append(req)
                    continue
                slot = self.free.pop()
                logits, self._cache = eng.try_prefix_replay(
                    self._cache, toks_list, slot
                )
                if logits is not None:
                    if self.obs.enabled:
                        self._trace_admission_start(req)
                        self.obs.tracer.instant(
                            "prefix_replay", pid=PID_REQUEST, tid=req.rid,
                            cat="prefill", slot=slot, tokens=len(toks_list))
                    self._finish_admission(req, slot, logits)
                    progressed = True
                    continue
            else:
                slot = self.free.pop()
            if self.obs.enabled:
                self._trace_admission_start(req)
            toks = np.asarray(toks_list, np.int32)
            resume, self._cache = eng.begin_chunked(self._cache, slot, toks)
            self._prefilling = _ChunkState(req=req, slot=slot, toks=toks, pos=resume)
            progressed = True
        for r in reversed(skipped):
            q.appendleft(r)
        return progressed

    def _chunk_admission_step(self) -> bool:
        """Spend this step's token quantum: at most one prefill chunk of
        the in-flight admission (opening one first if none is)."""
        eng = self.engine
        if self._prefilling is None:
            progressed = self._start_chunked_admission()
            if self._prefilling is None:
                return progressed
        st = self._prefilling
        n = min(self.chunk_tokens, len(st.toks) - st.pos)
        ok, logits, self._cache = eng.prefill_chunk(
            self.params, self._cache, st.slot, st.toks, st.pos, n
        )
        if not ok:
            # pool dry mid-prefill.  The prefilling request is the youngest
            # admission, so it is its own preemption victim (running
            # decodes keep priority): completed chunks are parked in the
            # prefix cache and the request re-queues at the head — its
            # re-admission resumes from the completed-chunk boundary, not
            # token 0.  An abort whose completed-chunk boundary didn't
            # advance since the last one is the chunked flavour of the
            # self-preemption livelock (the pool can't hold this prompt
            # alongside the running set, and its own fresh chunks evict
            # its parked progress): retire after `self_preempt_limit`.
            self._cache = eng.abort_chunked(self._cache, st.slot)
            self.free.append(st.slot)
            self._prefilling = None
            self.preemptions += 1
            self.prefill_aborts += 1
            self.health.record_event(
                "prefill_abort", slot=st.slot, rid=st.req.rid,
                reason="pool dry mid-chunked-prefill", pos=st.pos,
            )
            if self.obs.enabled:
                self.obs.tracer.instant(
                    "prefill_abort", cat="preemption", slot=st.slot,
                    rid=st.req.rid, pos=st.pos)
                self.obs.metrics.counter(
                    "prefill_aborts_total",
                    "chunked admissions aborted by pool pressure").inc()
            if self._note_self_preempt(st.req, st.pos):
                self.health.self_preempt_retires += 1
                msg = (
                    f"request {st.req.rid}: {st.req.self_preempts} chunked-"
                    f"prefill aborts without progress (pool cannot hold the "
                    f"prompt); retired"
                )
                warnings.warn(msg)
                self._retire(st.req, "rejected", msg, slot=st.slot)
            else:
                self._queue.appendleft(st.req)
            return True
        self.prefill_chunks += 1
        if self.obs.enabled:
            self.obs.tracer.complete(
                f"prefill_chunk[{st.pos // self.chunk_tokens}]",
                self.vtime, n, pid=PID_REQUEST, tid=st.req.rid,
                cat="prefill", slot=st.slot, start=st.pos, tokens=n)
        self.vtime += n
        st.pos += n
        if logits is not None:
            self._finish_admission(st.req, st.slot, logits)
            self._prefilling = None
        return True

    def step(self) -> StepReport:
        """One scheduler step: fault hooks + deadline sweep, admission
        work (one monolithic admission sweep, or one prefill chunk under
        the token quantum), then one batched decode step for everything
        resident — with a non-finite-logits watchdog that quarantines
        poisoned slots.  Returns a truthy :class:`StepReport` if any work
        was done — falsy with a non-empty queue means the head can never
        be admitted (stall)."""
        self._step_retired = []
        progressed = False
        progressed |= self._expire_deadlines()
        # pressure cleared? step back up the degradation ladder
        if self.engine.paged and self.engine.maybe_restore_budget():
            progressed = True
        if self.chunk_tokens is None:
            before = (len(self.running), len(self._queue), self.insert_retries)
            self._cache = self._admit(self._queue, self._cache, self._cur)
            progressed |= (
                (len(self.running), len(self._queue), self.insert_retries)
                != before
            )
        else:
            progressed |= self._chunk_admission_step()
        if self.running:
            if self.engine.paged:
                self._cache = self._ensure_append_capacity(self._queue, self._cache)
                if not self.running:
                    return StepReport(True, self._step_retired)
            active_np = np.zeros((self.engine.n_slots,), bool)
            for s in self.running:
                active_np[s] = True
            dev = self.engine.device
            nxt, logits, self._cache = self.engine.decode(
                self.params, torch.from_numpy(self._cur).to(dev), self._cache,
                active=torch.from_numpy(active_np).to(dev), generator=self._gen,
            )
            nxt = nxt.cpu().numpy()
            self.steps += 1
            self.occupancy.append(len(self.running))
            self.vtime += len(self.running)
            if self.watchdog:
                lg = logits.float().cpu().numpy()
                for slot in nonfinite_slots(lg, list(self.running)):
                    # quarantine ONLY the poisoned slot: its sampled token is
                    # garbage (drawn from non-finite logits), so it is
                    # discarded with the slot — the rest of the batch
                    # decodes on untouched
                    req = self.running.pop(slot)
                    self._cache = self._release(self._cache, slot)
                    reason = f"non-finite logits at decode step {self.steps}"
                    self.health.record_event(
                        "quarantine", slot=slot, rid=req.rid, reason=reason,
                    )
                    if self.obs.enabled:
                        self.obs.tracer.instant(
                            "quarantine", cat="health", slot=slot,
                            rid=req.rid, reason=reason)
                    self._retire(req, "quarantined", reason, slot=slot)
            for slot, req in list(self.running.items()):
                tok = int(nxt[slot])
                req.out.append(tok)
                self._step_tokens.append((req.rid, tok))
                self._cur[slot] = tok
                at_capacity = (
                    len(req.tokens) + len(req.out) - 1 >= self.engine.capacity
                )
                if (
                    len(req.out) >= req.max_new
                    or (req.eos is not None and tok == req.eos)
                    or at_capacity
                ):
                    self._retire(req, "finished", slot=slot)
                    del self.running[slot]
                    self._cache = self._release(self._cache, slot)
            progressed = True
        if self.obs.enabled:
            self._flush_step_obs()
        self.health.maybe_audit(self.engine, self.steps)
        return StepReport(progressed, self._step_retired)

    def _flush_step_obs(self) -> None:
        """End-of-step observability flush: stamp the step's buffered
        tokens at the *final* vtime (an admission-produced first token and
        a same-step decode token share one stamp — the clock semantics
        TTFT/ITL percentiles are derived from), then sample the counter
        tracks and gauges."""
        tr = self.obs.tracer
        for rid, tok in self._step_tokens:
            tr.instant("token", pid=PID_REQUEST, tid=rid, cat="decode",
                       token=tok)
        self._step_tokens = []
        tr.counter("occupancy", {"running": len(self.running),
                                 "queued": len(self._queue)})
        if self.engine.paged:
            a = self.engine.allocator
            track = {"in_use": a.n_in_use,
                     "free": len(a._free),
                     "cached": a.n_parked}
            tr.counter("pool", track)
        self.engine.sample_pool_gauges()
        self.obs.metrics.set_gauges(dict(
            sched_steps=self.steps,
            sched_vtime=self.vtime,
            sched_running=len(self.running),
            sched_queue_depth=len(self._queue),
            sched_preemptions=self.preemptions,
            sched_prefill_chunks=self.prefill_chunks,
            sched_prefill_aborts=self.prefill_aborts,
            sched_insert_retries=self.insert_retries,
        ))

    def run(self, requests: Sequence[Request]) -> ServeResult:
        """Serve ``requests`` to completion.  Returns a :class:`ServeResult`
        — a plain ``rid → generated tokens`` dict (back-compat) carrying
        the structured per-request outcomes in ``.outcomes``."""
        # deque: _admit pops FIFO from the head — list.pop(0) was O(n) per
        # admit, O(n²) across a burst of queued requests
        self.start()
        for r in requests:
            self.submit(r)
        while self.busy:
            if not self.step():
                raise RuntimeError(
                    "scheduler stalled: queued request cannot be "
                    "admitted into an empty engine"
                )
        return ServeResult(
            {r.rid: r.out for r in requests}, dict(self.outcomes)
        )

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancy)) if self.occupancy else 0.0
