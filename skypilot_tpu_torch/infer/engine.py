"""Continuous-batching inference engine over the paged or the contiguous
KV cache.

Counterpart of the core of ``skypilot_tpu/infer/engine.py``: paged KV
(block table, ref-counted block allocator; the default) or the
contiguous layout (``kv_block`` 0, env ``SKYTPU_KV_BLOCK=0``: one
``max_len`` row per slot, a separate pool of prefix rows), wave
admission grouped by prompt bucket, chunked prefill of long prompts,
staged decode bursts whose slots regroup by span rung, and the classic
single-token step (:meth:`InferenceEngine.step`). Greedy decoding
is the contract; temperature and top-k sample from the engine's own
``torch.Generator``. A sparse MoE config (``models/moe.py``) is served
through the same programs, the expert FFN in place of the dense one
(``kvcache._decode_out_ffn``), as in the reference; ``weights_int8``
refuses it.

A fixed pool of decode slots advances a burst of tokens per device call
for every active request, while new requests prefill into free slots
between bursts. By default every request reserves its worst-case KV
blocks (prompt plus token budget, capped by ``max_len``) at admission,
so decode never runs out of backing mid-flight; the pool, not a fault
path, limits admission (lazy growth, below, trades that for smaller
reservations).

Prompts longer than ``prefill_chunk`` (512 by default, as in the JAX
engine) claim a slot and prefill in chunks, one chunk between decode
bursts, so a long prompt never stalls the decoding slots for its whole
length; shorter prompts ride waves.

The prefix cache (``prefix_pool`` entries, off by default) keeps a
chunk path prompt's chunk-aligned prefix as ref-counted shared blocks:
a later prompt that shares it maps those blocks into its table row and
prefills only the suffix, copying a partially filled shared block on
write. Speculative decoding (``spec_k`` draft tokens, off by default)
replaces a plain burst with one verify round whenever some slot has a
draft: an n-gram drafter proposes up to K tokens per slot and
:func:`kvcache.verify_draft_staged` commits the matched run plus one
correction token, so greedy output is unchanged.

The reference's int8 recipe is an option of the engine: ``kv_int8``
keeps the KV pool in int8 with per-row bfloat16 scales, and
``weights_int8`` quantizes the block matrices and the LM head once, on
the device, and drops their float copies (w8a8 products in every
program).

The cross-replica KV handoff of disaggregated serving is the engine's
side of a two-tier service: :meth:`InferenceEngine.export_prefix_for`
snapshots a retired request's stored prefix blocks on the prefill tier,
:meth:`InferenceEngine.import_prefix` installs them into the decode
tier's pool and prefix index, and ``add_request(..., committed=...)``
admits the prompt plus its committed tokens through the resume context
(``_ctx``), whose chunked prefill reads the imported blocks as a prefix
hit.

Multi-tenant QoS (``qos``, a :class:`qos.FairScheduler`): before each
admission pass the waiting queue is reordered into priority lanes with
weighted fair queueing across tenants, and a queued request that
outranks a resident evicts it (:meth:`InferenceEngine.preempt_slot`):
the victim's committed rows retire into the prefix cache and it resumes
through the same ``_ctx`` seam a handoff uses, with the same greedy
tokens. A tenant's ``max_kv_blocks`` caps the blocks its slots
reference; a tenant at its cap steps aside while others admit. Lazy KV
growth (``kv_lazy``, env ``SKYTPU_KV_LAZY=1``) reserves the context plus
one burst of headroom at admission and grows each slot's table as its
bursts need rows; a slot the pool cannot grow sits the burst out.

The engine records the reference's serving metrics under its names
(``observability/metrics.py``): TTFT, TPOT, queue depth, slots, prefill
and decode timings, prefix-cache, speculation, lazy-growth and quota
counters.

Multi-LoRA serving (``adapters``, an :class:`adapters.AdapterCatalog`):
one base model serves a catalog of fine-tunes in one continuous batch.
A request naming a fine-tune (``add_request(..., adapter=name)``) pins
its adapter into the device pool at claim (hot-loading and evicting
LRU unpinned residents), every program gathers each row's (A, B) pair
from the per-slot id vector (:meth:`InferenceEngine.aid_device`), and
the prefix cache is keyed per adapter content (:meth:`_prefix_salt`).
An unknown name is a typed 404 at submit; a checkpoint that fails to
load fails its request typed (``Request.error``, 503), and the base
weights are never served under a fine-tune's name. A request whose
adapter cannot load because every pool slot is pinned steps aside
while the traffic behind it admits.

A draft model (``draft_engine``, an :class:`infer.draft.DraftEngine`)
puts a ``model`` rung above the n-gram drafter: its requests draft in
one batched staged burst of the small model per verify round, on the
draft engine's own paged pool, and with ``spec_pipeline`` (env
``SKYTPU_SPEC_PIPELINE``, on by default) the next round's draft burst is
enqueued behind the verify calls, before their tokens are fetched. A
request whose acceptance collapses demotes ``model`` -> ``ngram`` ->
``off``. The draft model drafts from the base weights: a fine-tune
shapes only the target's verify.

Crash recovery: every device dispatch seam (the admission wave, a
prefill chunk, both halves of a decode burst, a spec verify) runs
behind a typed boundary (``_dispatch_boundary``, chaos point
``engine.dispatch``): a failure there surfaces as a recoverable
:class:`EngineDispatchError`, and :meth:`InferenceEngine.recover` resets
the engine and re-admits every queued and in-flight request through the
``_ctx`` resume seam preemption uses, with the same greedy tokens.

Observability, as in the reference: every device dispatch runs through
the compile watch (``observability/flight.py``: program keys, the
first-dispatch wall, the unexpected-compile alarm after
:meth:`InferenceEngine.declare_warmup_complete`), and every burst (wave,
chunk, decode, verify, the pipelined draft), preemption, recovery and
retirement appends one flight record with its program identity, member
requests and trace ids, the host wall split into dispatch and fetch,
the device-time calibrator's ``dev_ms_est`` and the roofline's FLOPs and
bytes (``observability/attribution.py``). Retirement records anchor the
per-request forensics ledger and the streaming tail detector
(``observability/forensics.py``), and each request records the
reference's spans (``engine.request``, ``engine.queue_wait``,
``engine.prefill``, ``engine.decode``). :meth:`InferenceEngine.
warm_programs` dispatches every program key once before traffic.

A contiguous engine answers the paged-only features as the reference's
does: no lazy growth, no KV quotas, ``blocks_used()`` 0, no handoff
export (``None``) or import (0), and its big-cache reads take the
gather, never K1; ``kv_kernel`` on it emits the typed event
``engine.kv_kernel_fallback``. Its prefix cache copies whole rows into
and out of a separate pool (``kvcache.pool_store``/``pool_load``), keyed
through :meth:`PrefixIndex.acquire_row`.

Tensor-parallel serving (``mesh``, a tp group of devices): the weights,
the w8a8 weights, the KV cache and the prefix pool are split over the
group by the reference's logical axes (``parallel.sharding.split_tree``:
Megatron heads, mlp and vocab; the cache's kv heads), and every program
runs each layer shard by shard, joining the shards at wo, w_down, the
embedding and the head (``infer/kvcache.py``), so K1 and K2 run on each
shard's own heads and cache slice. The host side stays single: one
scheduler, allocator, block table and prefix index serve every shard.
:meth:`InferenceEngine.sharded_init` draws a split tree without ever
holding the whole one on a device.

Deliberate differences from the reference: the JAX engine padded
admission waves to fixed row counts to avoid recompiles; PyTorch runs
eagerly, so the port dispatches each wave at its own size (a wave's
program key carries its real row count) and keeps no spare slot for
padding rows. The warm-up runs against a free slot whose table row is
all-sentinel instead (contiguous: any free slot; its rows are dead). A
non-final prefill chunk is not fetched, so its flight record's
``fetch_wall_ms`` is 0. On a paged cache the big-cache reads run K1
whatever ``kv_kernel`` says (the single step's too), and
``kv_kernel`` only decides the typed event on a contiguous one. The
reference runs tp as one process over N local chips and lets XLA SPMD
partition the unchanged programs; the port keeps the one process (a
single controller) but runs each shard's part of a layer itself and
joins the shards by copies to the first shard's device, not by NCCL
collectives, and a tp group may repeat a device, so N shards can share
one card (one process per card over NCCL is left for later). Under tp
the adapter pool stays whole on the first device and each shard reads
its heads' slices of it, and a draft engine runs whole on the first
device; MoE configs are refused (:class:`TpUnsupportedError`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import math
import os
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, chaos, resolve_device
from skypilot_tpu_torch.infer import adapters as adapters_lib
from skypilot_tpu_torch.infer import kvcache, sampling
from skypilot_tpu_torch.infer import qos as qos_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import attribution as attribution_lib
from skypilot_tpu_torch.observability import flight as flight_lib
from skypilot_tpu_torch.observability import forensics as forensics_lib
from skypilot_tpu_torch.observability import metrics, tracing
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.utils import timeline

# The reference engine's serving metrics (``skypilot_tpu/infer/
# engine.py``), same names, types, labels and help, for the quantities
# the port computes.
PREFILL_SECONDS = metrics.histogram(
    "skytpu_prefill_seconds",
    "Admission-wave prefill latency, dispatch to first-token fetch, "
    "by prompt bucket", labelnames=("bucket",))
PREFILL_REQUESTS = metrics.counter(
    "skytpu_prefill_requests_total",
    "Requests prefilled, by prompt bucket", labelnames=("bucket",))
WAVE_SIZE = metrics.histogram(
    "skytpu_admission_wave_size",
    "Real (pre-padding) requests per admission wave",
    buckets=(1, 2, 4, 8, 16, 32, 64))
DECODE_STEP_SECONDS = metrics.histogram(
    "skytpu_decode_step_seconds",
    "Decode device-call latency, dispatch to token fetch (one call "
    "decodes a burst of k tokens per active slot)")
DECODE_STALL_SECONDS = metrics.histogram(
    "skytpu_decode_stall_seconds",
    "Time active decode slots waited on a prefill device call (one "
    "chunk or one admission wave) — the interference chunked prefill "
    "bounds",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0))
DECODE_TOKENS = metrics.counter(
    "skytpu_decode_tokens_total",
    "Output tokens committed to requests by decode")
TTFT_SECONDS = metrics.histogram(
    "skytpu_ttft_seconds",
    "Per-request time to first token (submit/enqueue to first token)",
    buckets=metrics.latency_buckets())
TPOT_SECONDS = metrics.histogram(
    "skytpu_tpot_seconds",
    "Per-request mean time per output token after the first",
    buckets=metrics.latency_buckets())
SLOTS_ACTIVE = metrics.gauge(
    "skytpu_slots_active", "Decode slots currently serving a request")
SLOTS_TOTAL = metrics.gauge(
    "skytpu_slots_total", "Configured decode slot pool size")
ENGINE_WAITING = metrics.gauge(
    "skytpu_engine_waiting",
    "Requests accepted by the engine but not yet prefilled")
REQUESTS_FINISHED = metrics.counter(
    "skytpu_requests_finished_total", "Requests fully generated")
PREFIX_HITS = metrics.counter(
    "skytpu_prefix_cache_hits_total",
    "Admissions that reused a resident prompt-prefix's KV rows "
    "(suffix-only prefill)")
PREFIX_MISSES = metrics.counter(
    "skytpu_prefix_cache_misses_total",
    "Admissions eligible for prefix reuse (pool enabled, prompt longer "
    "than one chunk) that found no resident prefix")
PREFIX_EVICTIONS = metrics.counter(
    "skytpu_prefix_cache_evictions_total",
    "Prefix-pool rows evicted (LRU) to admit a new prefix")
PREFIX_HIT_RATIO = metrics.gauge(
    "skytpu_prefix_cache_hit_ratio",
    "Lifetime fraction of prefix-eligible admissions that reused a "
    "resident prefix (hits / (hits + misses); 0 until the first "
    "eligible admission) — a gauge so fleet aggregation keeps the "
    "per-replica spread affinity routing is supposed to close")
PREFILL_CHUNKS = metrics.counter(
    "skytpu_prefill_chunks_total",
    "Chunked-prefill device calls (one fixed-size chunk each, "
    "interleaved with decode bursts)")
KV_BLOCKS_TOTAL = metrics.gauge(
    "skytpu_kv_blocks_total",
    "Paged KV cache: physical blocks in the pool (0 when the engine "
    "runs the contiguous layout)")
KV_BLOCKS_USED = metrics.gauge(
    "skytpu_kv_blocks_used",
    "Paged KV cache: blocks currently referenced by decode slots "
    "and/or resident prefix-cache entries")
KV_COW_COPIES = metrics.counter(
    "skytpu_kv_cow_copies_total",
    "Paged KV cache copy-on-write block copies (partial shared blocks "
    "duplicated on prefix store/hit before a writer touches them)")
SPEC_DRAFTED = metrics.counter(
    "skytpu_spec_drafted_total",
    "Speculative-decode draft tokens proposed (n-gram/prompt-lookup) "
    "and scored by a verify burst")
SPEC_ACCEPTED = metrics.counter(
    "skytpu_spec_accepted_total",
    "Speculative-decode draft tokens accepted (matched the model's "
    "greedy argmax and were committed)")
SPEC_ROLLBACKS = metrics.counter(
    "skytpu_spec_rollbacks_total",
    "Speculative-decode draft tokens not committed — rejected by "
    "verification, or discarded when the request retired mid-run "
    "(their KV rows sit past the committed length and are never read)")
SPEC_ACCEPT_RATE = metrics.gauge(
    "skytpu_spec_acceptance_rate",
    "Speculative-decode lifetime acceptance rate "
    "(accepted / drafted; 0 until the first draft)")
SPEC_DRAFT_TOKENS = metrics.counter(
    "skytpu_spec_draft_tokens_total",
    "Speculative-decode draft tokens proposed, by drafter kind: "
    "'model' = the draft-model engine (infer/draft.py), 'ngram' = "
    "the host prompt-lookup drafter (also the demotion fallback) — "
    "the fallback ladder model -> ngram -> off is observable per "
    "window", labelnames=("drafter",))
SPEC_VERIFY_WALL = metrics.counter(
    "skytpu_spec_verify_wall_seconds_total",
    "Host wall seconds spent per verify round, dispatch to fetch — "
    "the window the async draft pipeline overlaps draft work into")
SPEC_OVERLAP_WALL = metrics.counter(
    "skytpu_spec_overlap_wall_seconds_total",
    "Host wall seconds spent dispatching the NEXT round's draft "
    "rollout while the current verify was in flight (the pipelined "
    "predraft); overlap ratio = this over "
    "skytpu_spec_verify_wall_seconds_total")
DECODE_ATTN_ROWS = metrics.histogram(
    "skytpu_decode_attn_rows",
    "Span bucket (logical KV rows gathered per slot) actually "
    "dispatched for a decode/verify burst — decode attention "
    "bandwidth tracks this, not max_len (the full-view fallback)",
    buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
             32768))
KV_LAZY_GROWS = metrics.counter(
    "skytpu_kv_lazy_grows_total",
    "Paged KV blocks allocated by lazy per-burst growth "
    "(SKYTPU_KV_LAZY=1: admission reserves prompt + one burst of "
    "rows; the rest allocates at burst dispatch)")
QOS_KV_QUOTA_STALLS = metrics.counter(
    "skytpu_qos_kv_quota_stalls_total",
    "Admissions stalled because the request's tenant is at its "
    "per-tenant KV-block quota (qos tenant spec max_kv_blocks) — a "
    "typed wait for the tenant's own retirements, never a 503; other "
    "tenants keep admitting",
    labelnames=("tenant",))
QOS_KV_BLOCKS = metrics.gauge(
    "skytpu_qos_kv_blocks_used",
    "Paged KV blocks currently charged to each tenant (table "
    "references, shared prefix blocks charged to every referencing "
    "tenant) — the quantity max_kv_blocks caps",
    labelnames=("tenant",))
ENGINE_RECOVERIES = metrics.counter(
    "skytpu_engine_recoveries_total",
    "Engine crash recoveries: a device dispatch seam raised, the "
    "engine reset (allocator/table/index wiped) and every in-flight "
    "request was re-admitted through the preemption resume path, "
    "by the seam that failed", labelnames=("seam",))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    submit_s: float = 0.0
    first_token_s: Optional[float] = None
    done: bool = False
    eos_id: Optional[int] = None
    # Identity of this request's trace span ("engine.request", recorded
    # at retirement): its queue-wait/prefill/decode child spans parent to
    # it; ``parent_id`` links it into the caller's trace (traceparent).
    span_ctx: Optional[tracing.SpanContext] = None
    parent_id: Optional[str] = None
    n_chunks: int = 0                 # prefill chunks run for this request
    cached_len: int = 0               # prompt rows reused from the cache
    # A resume (admitted with committed tokens, as a KV handoff is):
    # the context rows its claim reused from the prefix cache (the
    # imported blocks); ``cached_len`` stays the first admission's.
    resumed_len: int = 0
    # Speculative decoding: lifetime drafted/accepted tokens (the
    # response trailer) and the drafter state. ``spec_mode`` is the
    # drafter rung ("model" with a draft engine, else "ngram"; each
    # acceptance collapse demotes one rung, down to "off");
    # ``spec_mode_drafted``/``_accepted`` count since the last demotion.
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_off: bool = False
    drafter: Optional[Any] = None
    spec_mode: Optional[str] = None
    spec_mode_drafted: int = 0
    spec_mode_accepted: int = 0
    # Multi-tenant QoS: ``tenant`` feeds the fair scheduler and the
    # per-tenant KV quota; ``priority`` picks the lane (higher preempts
    # lower); ``preemptions`` counts evictions mid-decode (the trailer).
    tenant: str = qos_lib.DEFAULT_TENANT
    priority: int = 0
    preemptions: int = 0
    # Engine crash recoveries this request survived: each is an
    # involuntary preemption through the same resume context (the
    # trailer).
    recoveries: int = 0
    # True while the request sits queued because its tenant is at its
    # max_kv_blocks quota: the stall counter fires once per episode.
    kv_quota_stalled: bool = False
    # Multi-LoRA: ``adapter`` names the fine-tune this request generates
    # under (None = the base model); ``adapter_slot`` is the device pool
    # slot serving it (0 = the all-zeros base adapter), assigned at
    # claim; ``adapter_pinned`` tracks the catalog's in-flight refcount
    # so release happens exactly once per acquire; ``error`` carries a
    # typed failure body (adapter load failure) the server returns
    # instead of tokens.
    adapter: Optional[str] = None
    adapter_slot: int = 0
    adapter_pinned: bool = False
    error: Optional[Dict[str, Any]] = None
    # Admission-stall episodes: ``stall_ms`` accumulates closed episodes
    # by cause (pool_dry / kv_quota / adapter_pin); an open one is
    # (stall_cause, stall_begin_s), closed at the successful claim.
    stall_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    stall_cause: Optional[str] = None
    stall_begin_s: float = 0.0
    prefill_begin_s: float = 0.0      # chunk path: claim time


@dataclasses.dataclass
class _ChunkState:
    """A request mid-chunked-prefill: slot claimed, rows [0, pos)
    resident (reused prefix and/or completed chunks), first token (or,
    on a resume, the next token) not yet produced. ``ctx`` is the
    admission-time context: the prompt, or prompt + committed tokens on
    a resume."""
    req: Request
    pos: int            # next row offset to prefill
    total: int          # len(ctx)
    ctx: List[int]


@dataclasses.dataclass
class BurstHandle:
    """A dispatched-but-unfetched decode burst (see
    :meth:`InferenceEngine.dispatch_decode_burst`). Span regrouping may
    split one burst round over several device programs: ``parts`` pairs
    each program's token tensor [k, slots] with the slots it decoded
    for."""
    parts: List[Tuple[torch.Tensor, List[int]]]
    k: int
    slot_req: Dict[int, Request]      # slot->request snapshot at dispatch
    # Span opened at dispatch, closed when the tokens are fetched:
    # records into skytpu_decode_step_seconds.
    span: Optional[timeline.Event] = None
    # Per-part span rungs and compile-watch keys (parallel to ``parts``):
    # the completion's flight records carry each part's program identity
    # and look its calibrated device time up by key.
    spans: List[Optional[int]] = dataclasses.field(default_factory=list)
    keys: List[Optional[str]] = dataclasses.field(default_factory=list)
    # When the last part's dispatch returned: the record splits its host
    # wall into dispatch and fetch here.
    dispatch_s: Optional[float] = None


class NoFreeSlotError(RuntimeError):
    """:meth:`InferenceEngine.warm_programs` dispatches every program
    against a free slot whose table row is all-sentinel (the port keeps
    no spare slot); with every slot occupied there is none to warm on."""

    def __init__(self):
        super().__init__("warm_programs needs a free slot (the port keeps "
                         "no spare slot); warm before traffic")
        self.typed_error = {"type": "no_free_slot",
                            "message": str(self)}


def warm_slot(free_slots, block_table: Optional[np.ndarray],
              sentinel: int) -> int:
    """A free slot whose table row is all-sentinel: a warm-up's writes
    land in the trash block (``block_table`` None, the contiguous
    layout: any free slot, whose rows are dead). Raises
    :class:`NoFreeSlotError` when there is none."""
    for s in free_slots:
        if block_table is None or (block_table[s] == sentinel).all():
            return s
    raise NoFreeSlotError()


@contextlib.contextmanager
def warm_sweep(watch: flight_lib.CompileWatch, cache: Dict[str, Any],
               generator: torch.Generator):
    """The frame of a warm-up sweep (the engine's and the drafter's
    ``warm_programs``): the block runs under ``metrics.suppress``; the
    cache's lengths and pending tokens and the generator's stream are
    restored afterwards, so no greedy token changes; then the watch's
    new keys are drained (they are no burst's to claim) and their
    compile metrics republished from the watch registry."""
    pre_keys = set(watch.summary())
    saved = [(c, c["length"].clone(), c["last_token"].clone())
             for c in sharding.shards_of(cache)]
    saved_gen = generator.get_state()
    try:
        with metrics.suppress():
            yield
    finally:
        for c, length, last in saved:
            c["length"].copy_(length)
            c["last_token"].copy_(last)
        generator.set_state(saved_gen)
    watch.drain_new()
    summ = watch.summary()
    for key in summ:
        if key not in pre_keys:
            flight_lib.COMPILE_SECONDS.labels(program=key).observe(summ[key])
            flight_lib.PROGRAMS_COMPILED.inc()


class PromptTooLongError(ValueError):
    """Prompt exceeds the engine's largest prompt bucket. A client
    error, not an engine failure: the server maps it to HTTP 400 with a
    typed body (``typed_error``) instead of a 500."""

    def __init__(self, prompt_len: int, max_prompt_len: int):
        super().__init__(
            f"prompt length {prompt_len} exceeds max bucket "
            f"{max_prompt_len}")
        self.prompt_len = prompt_len
        self.max_prompt_len = max_prompt_len
        self.typed_error = {
            "type": "prompt_too_long",
            "message": str(self),
            "prompt_len": prompt_len,
            "max_prompt_len": max_prompt_len,
        }


class KvQuotaUnsatisfiableError(ValueError):
    """The request's own worst-case KV-block need exceeds its tenant's
    ``max_kv_blocks`` quota, so no amount of the tenant's retirements
    could ever admit it: a client error (HTTP 400, typed body), never a
    stall or a 500."""

    def __init__(self, tenant: str, need: int, quota: int):
        super().__init__(
            f"request needs {need} KV blocks but tenant "
            f"{tenant!r} is capped at max_kv_blocks={quota}")
        self.typed_error = {
            "type": "kv_quota_unsatisfiable",
            "message": str(self),
            "tenant": tenant,
            "need_blocks": need,
            "max_kv_blocks": quota,
        }


class TpUnsupportedError(NotImplementedError):
    """A feature the tensor-parallel engine does not serve yet (ROADMAP
    Queue 1 item 1: MoE ``--ep``)."""

    def __init__(self, feature: str):
        super().__init__(
            f"{feature} under a tp group is not ported yet (ROADMAP "
            f"Queue 1 item 1)")
        self.feature = feature


class EngineDispatchError(RuntimeError):
    """A device dispatch seam (admission wave, prefill chunk, decode
    burst, spec verify) raised. The engine's host bookkeeping may
    disagree with device state, so the only safe move is a full
    ``reset()``, but every in-flight request is recoverable through the
    preemption resume path (:meth:`InferenceEngine.recover`): a crash is
    an involuntary preemption. ``recoverable`` is the flag the server
    loop keys recovery on."""

    recoverable = True

    def __init__(self, seam: str, cause: BaseException):
        super().__init__(f"engine dispatch failed at {seam}: {cause}")
        self.seam = seam
        self.cause = cause
        self.typed_error = {
            "type": "engine_dispatch_failed",
            "message": str(self),
            "seam": seam,
        }


class KvPoolWedgedError(RuntimeError):
    """The paged KV pool is exhausted and nothing can make progress:
    every block is held by an active slot (lazy growth has no victim to
    evict). The pool is undersized for the configured slot count, an
    operator error, not a transient."""

    def __init__(self, detail: str):
        super().__init__(detail)
        self.typed_error = {
            "type": "kv_pool_wedged",
            "message": detail,
        }


@contextlib.contextmanager
def _dispatch_boundary(seam: str):
    """Typed failure boundary around one device dispatch seam. The
    ``engine.dispatch`` chaos point fires inside it, so an injected
    fault takes the path a real device error would. Typed client errors
    (prompt too long, unsatisfiable quota) pass through unwrapped, as do
    dispatch errors already wrapped by a nested seam."""
    try:
        chaos.point("engine.dispatch", seam=seam)
        yield
    except (EngineDispatchError, PromptTooLongError,
            KvQuotaUnsatisfiableError):
        raise
    except Exception as e:
        raise EngineDispatchError(seam, e) from e


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise PromptTooLongError(n, buckets[-1])


def kv_block_len(max_len: int, kv_block: int, on_card: bool) -> int:
    """The KV block length: the largest divisor of ``max_len`` no larger
    than ``kv_block`` (the block axis must tile ``max_len`` exactly), as
    in the JAX engine. ``on_card`` (an engine whose pools K1 reads on the
    card): the largest such divisor that K1's ``wgmma`` multi-row body
    also reads (:func:`ops.paged_attention.tma_block_len`), so that bf16
    chunks never fall to the ``mma.sync`` body and int8 chunks run at
    all; a ``max_len`` such as 1064 gives 8 there, not the JAX engine's
    152. Where no divisor qualifies (``max_len`` not a multiple of 8) the
    JAX engine's block stands."""
    b = min(kv_block, max_len)
    while max_len % b:
        b -= 1
    if on_card:
        k1 = next((d for d in range(b, 0, -1)
                   if max_len % d == 0 and pa.tma_block_len(d)), None)
        b = k1 or b
    return b


def paged_block_len(max_len: int, kv_block: int, device: torch.device,
                    kv_int8: bool) -> int:
    """The block length of a paged pool on ``device``
    (:func:`kv_block_len`). An int8 pool on the card whose block K1's
    multi-row body cannot read raises ``ValueError`` here, when the
    engine is built, not at its first chunk."""
    on_card = device.type == "cuda"
    b = kv_block_len(max_len, kv_block, on_card)
    if kv_int8 and on_card and not pa.tma_block_len(b):
        raise ValueError(
            f"an int8 KV cache on the card needs a max_len that is a "
            f"multiple of 8 (got {max_len}): K1 reads int8 pools in "
            f"chunks only in blocks of 8, 16, 32 or a multiple of 64")
    return b


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a blocking copy."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _span_ladder(buckets, max_len: int) -> Tuple[int, ...]:
    """The span-bucket ladder: ascending rungs, largest always
    ``max_len`` (the full view — also the only rung when bucketing is
    disabled). ``buckets``: None -> the default power-of-two ladder
    (max_len/8, /4, /2, max_len); an explicit iterable -> its positive
    rungs clamped below max_len; empty/0 -> disabled."""
    if buckets is None:
        ladder = [max_len // d for d in (8, 4, 2)]
    elif isinstance(buckets, int):
        ladder = [buckets] if buckets > 0 else []    # 0 = disabled
    else:
        ladder = [int(b) for b in buckets if int(b) > 0]
    rungs = {s for s in ladder if 0 < s < max_len}
    rungs.add(max_len)
    return tuple(sorted(rungs))


class PrefixIndex:
    """Host-side index over resident prompt prefixes.

    Hash granularity is the prefill chunk: a prompt's prefix is
    cacheable at every multiple of ``block`` tokens, keyed by a
    blake2b-128 digest of the token bytes (content-addressed — a
    Python ``hash`` collision would silently serve the wrong prefix).
    ``salt`` prefixes every digest: the JAX engine feeds the request's
    ADAPTER identity through it, because stored K/V rows carry the
    fine-tune's wk/wv deltas — without the salt, two adapters sharing
    a prompt prefix would share cached K/V computed under whichever
    stored first (silently serving the wrong model). The port serves
    no adapters yet, so its engine keeps the empty salt, the key space
    of the reference's base-model requests and of the load balancer's
    ``prefix_affinity_key``.
    One ENTRY holds one stored prefix; every chunk-multiple key of
    that prefix points at the entry, so a shorter shared prefix hits
    it too. Eviction is LRU over entries (a hit or a store bumps the
    entry); evicting drops all of its keys.

    An entry's *payload* is storage-layout specific: the contiguous
    engine stores a pool ROW id (int, allocated via :meth:`acquire_row`);
    the paged engine stores a TUPLE of ref-counted block ids
    (``insert_entry`` — the caller owns the ref-count bookkeeping and
    decrefs whatever ``evict_lru``/``clear``/``insert_entry`` report
    as evicted). ``rows`` caps resident entries either way.
    """

    def __init__(self, rows: int, block: int):
        self.rows = rows
        self.block = block
        self.clear()

    def clear(self) -> None:
        self._tick = 0
        self._keys: Dict[bytes, Tuple[Any, int]] = {}  # -> (payload, n)
        self._ent_keys: Dict[Any, set] = {}
        self._ent_used: Dict[Any, int] = {}            # payload -> LRU

    def _digest(self, prompt: List[int], n: int,
                salt: bytes = b"") -> bytes:
        return hashlib.blake2b(
            salt + np.asarray(prompt[:n], np.int64).tobytes(),
            digest_size=16).digest()

    def eligible(self, prompt: List[int]) -> bool:
        # The shortest cacheable prefix is one block, and at least one
        # suffix token must remain to produce the first-token logits.
        return len(prompt) > self.block

    def payloads(self) -> List[Any]:
        return list(self._ent_used)

    def lookup(self, prompt: List[int],
               salt: bytes = b"") -> Optional[Tuple[Any, int]]:
        """Longest resident chunk-aligned proper prefix of ``prompt``
        (under ``salt`` — the adapter-identity namespace); returns
        (payload, cached_len) and bumps the entry's LRU stamp."""
        for k in range((len(prompt) - 1) // self.block, 0, -1):
            ent = self._keys.get(
                self._digest(prompt, k * self.block, salt))
            if ent is not None:
                self._tick += 1
                self._ent_used[ent[0]] = self._tick
                return ent
        return None

    def _drop(self, payload) -> None:
        for key in self._ent_keys.pop(payload, ()):
            del self._keys[key]
        self._ent_used.pop(payload, None)

    def evict_lru(self) -> Optional[Any]:
        """Drop the least-recently-used entry; returns its payload (the
        caller releases the storage) or None when empty."""
        if not self._ent_used:
            return None
        payload = min(self._ent_used, key=self._ent_used.get)
        self._drop(payload)
        return payload

    def payloads_lru(self) -> List[Any]:
        """Resident payloads, least-recently-used first."""
        return sorted(self._ent_used, key=self._ent_used.get)

    def evict_entry(self, payload) -> None:
        """Drop one specific entry (the caller releases its storage)."""
        self._drop(payload)

    def acquire_row(self) -> Tuple[int, bool]:
        """Contiguous-pool payloads: a free row in [0, rows), or the LRU
        row evicted (its keys dropped). Returns (row, evicted)."""
        evicted = False
        free = [r for r in range(self.rows) if r not in self._ent_used]
        if free:
            row = free[0]
        else:
            row = min(self._ent_used, key=self._ent_used.get)
            self._drop(row)
            evicted = True
        self._tick += 1
        self._ent_used[row] = self._tick
        return row, evicted

    def insert_entry(self, prompt: List[int], n_tokens: int,
                     payload, salt: bytes = b"") -> List[Any]:
        """Paged payloads: admit a new entry, evicting LRU entries past
        the ``rows`` cap. Returns the evicted payloads (caller decrefs
        their blocks)."""
        evicted: List[Any] = []
        while len(self._ent_used) >= self.rows:
            p = self.evict_lru()
            if p is None:
                break
            evicted.append(p)
        self._tick += 1
        self._ent_used[payload] = self._tick
        self.register(prompt, n_tokens, payload, salt)
        return evicted

    def register(self, prompt: List[int], n_tokens: int,
                 payload, salt: bytes = b"") -> None:
        """Point every not-yet-resident chunk multiple <= n_tokens at
        ``payload`` (shorter multiples already resident keep their
        entry — both copies hold identical bytes)."""
        for k in range(1, n_tokens // self.block + 1):
            d = self._digest(prompt, k * self.block, salt)
            if d not in self._keys:
                self._keys[d] = (payload, k * self.block)
                self._ent_keys.setdefault(payload, set()).add(d)


class NGramDrafter:
    """Prompt-lookup speculative drafter (host-side, zero device work).

    The request's context (prompt + committed tokens) is indexed by
    trailing n-gram: ``_index`` maps each n-gram to the START of its
    most recent occurrence that already has a continuation. Drafting
    looks up the context's last n tokens and proposes the up-to-k
    tokens that followed that earlier occurrence — the prompt-lookup
    heuristic: repeated spans (shared boilerplate, quoted input, a
    generation that has entered a cycle) verify at near-full
    acceptance, and a miss costs nothing (empty draft).

    No second model, no trained weights: correctness never depends on
    draft quality because verification is greedy-exact — a bad draft
    only wastes the verify burst's spare positions.
    """

    def __init__(self, tokens: List[int], n: int = 2):
        self.n = max(int(n), 1)
        self.tokens: List[int] = []
        self._index: Dict[Tuple[int, ...], int] = {}
        self.extend(tokens)

    def extend(self, toks) -> None:
        """Append committed tokens, indexing each n-gram the moment it
        gains a continuation (the trailing n-gram itself is never
        indexed — it has nothing after it to draft)."""
        for t in toks:
            self.tokens.append(int(t))
            j = len(self.tokens) - self.n - 1
            if j >= 0:
                self._index[tuple(self.tokens[j:j + self.n])] = j

    def catch_up(self, prompt: List[int], generated: List[int]) -> None:
        """Sync with the request after tokens committed through any
        path (verify bursts, a plain-decode fallback burst, the
        admission first token)."""
        missing = len(prompt) + len(generated) - len(self.tokens)
        if missing > 0:
            self.extend(generated[len(generated) - missing:])

    def draft(self, k: int) -> List[int]:
        """Up to ``k`` proposed continuation tokens ([] on a miss or a
        context shorter than one n-gram — degenerate prompts draft
        nothing rather than guessing).

        Self-extending: when the matched continuation runs into the
        end of the context (the most recent occurrence is near the
        tail — ALWAYS the case once generation enters a cycle), the
        lookup continues from the draft's own tail n-gram, which by
        construction re-matches an earlier occurrence. A tight loop
        therefore drafts the full K instead of the 1-2 tokens left
        after the nearest match."""
        if k <= 0 or len(self.tokens) < self.n:
            return []
        out: List[int] = []
        # Only the trailing n tokens ever feed the key — keep the
        # lookup O(n + k), not O(context): drafting runs per slot per
        # burst on the verify hot path.
        tail = self.tokens[-self.n:]
        while len(out) < k:
            key = tuple((tail + out)[-self.n:])
            j = self._index.get(key)
            if j is None:
                break
            take = self.tokens[j + self.n:j + self.n + k - len(out)]
            if not take:
                break
            out.extend(take)
        return out




class InferenceEngine:
    """Single-model continuous-batching engine on one device.

    ``params`` are the model's tensors (``models/llama.py``), moved to
    ``device`` if they live elsewhere; serving passes them in
    ``cfg.dtype``. ``device`` defaults to the CUDA card and raises when
    there is none; tests pass ``"cpu"``. ``plain_attention`` runs the
    kernels' plain versions, the reference the kernel path is held to.

    ``kv_int8``: int8 KV pools with bfloat16 scales, whatever
    ``cfg.dtype`` is. ``weights_int8``: quantize the seven block matrices
    and the head once, on ``device`` (``kvcache.quantize_block_weights``,
    ``quantize_head``), and keep only the slim float tree (embedding and
    norms); ``qweights`` passes that int8 tree pre-built (``params`` may
    then be slim already).

    ``prefix_pool``: resident prompt prefixes (0 disables; needs
    chunking). ``spec_k``: draft tokens per slot per verify round,
    clamped to [0, 16] and forced to 0 under temperature sampling (0
    disables). ``spec_drafter``: request -> drafter factory (the
    :class:`NGramDrafter` protocol, ``catch_up``/``draft``); None is
    the n-gram drafter over the prompt. ``draft_engine``: a
    :class:`infer.draft.DraftEngine` on the same device with
    ``n_slots`` slots (None: no model rung); ``spec_pipeline``: enqueue
    the next round's draft burst while the verify is in flight (None
    reads ``SKYTPU_SPEC_PIPELINE``, default on; off without a draft
    engine).

    ``kv_block``: the paged layout's block length (None reads
    ``SKYTPU_KV_BLOCK``, default 256); 0 or less builds the contiguous
    layout (one ``max_len`` row per slot, ``kv_blocks`` unused).
    ``kv_kernel`` (None reads ``SKYTPU_KV_KERNEL``): a paged engine's
    big-cache reads run K1 either way; on a contiguous engine, which has
    no block table, asking for it emits ``engine.kv_kernel_fallback``.

    ``qos``: a :class:`qos.FairScheduler` (None: FIFO admission, no
    preemption, no KV quota). ``kv_lazy``: lazy KV growth (None reads
    ``SKYTPU_KV_LAZY``; paged only). ``adapters``: the multi-LoRA
    catalog (None: the adapterless path, whose programs run exactly as
    before); its pool moves to ``device`` if it lives elsewhere.

    ``mesh``: a tensor-parallel group, a sequence of devices in rank
    order (a device may repeat; one device is no group), given instead
    of ``device``. The engine runs on the first; ``params`` (whole, or
    split by :meth:`sharded_init`), ``qweights``, the cache and the
    prefix pool are split over the group after quantization, and a
    split that does not divide the heads, kv heads, mlp or vocab evenly
    raises ``ValueError``. ``adapters`` and ``draft_engine`` live whole
    on the first device; an MoE config raises
    :class:`TpUnsupportedError`.

    ``flight_recorder``: the flight ring the engine records into (None:
    the process recorder ``flight.RECORDER``). ``forensics``: retirement
    records and tail detection (None reads ``SKYTPU_FORENSICS``, default
    on); ``exemplar_store``: where tail exemplars pin (None: the process
    store).
    """

    def __init__(self, params: llama.Params, cfg: llama.LlamaConfig,
                 n_slots: int = 8, max_len: int = 1024,
                 prompt_buckets: Tuple[int, ...] = (128, 512, 1024),
                 sampling_params: sampling.SamplingParams = sampling.SamplingParams(),
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_wave: Optional[int] = None,
                 kv_block: Optional[int] = None,
                 kv_blocks: Optional[int] = None, span_buckets=None,
                 prefill_chunk: Optional[int] = 512,
                 prefix_pool: int = 0, spec_k: int = 0,
                 spec_drafter: Optional[Callable] = None,
                 draft_engine: Optional[Any] = None,
                 spec_pipeline: Optional[bool] = None,
                 kv_int8: bool = False, weights_int8: bool = False,
                 qweights: Optional[kvcache.QWeights] = None,
                 device: DeviceLike = None,
                 plain_attention: bool = False,
                 kv_kernel: Optional[bool] = None,
                 kv_lazy: Optional[bool] = None,
                 qos: Optional[qos_lib.FairScheduler] = None,
                 adapters: Optional[adapters_lib.AdapterCatalog] = None,
                 mesh: Optional[Sequence[DeviceLike]] = None,
                 flight_recorder: Optional[
                     flight_lib.FlightRecorder] = None,
                 forensics: Optional[bool] = None,
                 exemplar_store: Optional[
                     forensics_lib.ExemplarStore] = None):
        if mesh and device is not None:
            raise ValueError("pass a tp group as mesh or one device, not "
                             "both")
        self.devices = ([resolve_device(d) for d in mesh] if mesh
                        else [resolve_device(device)])
        self.device = self.devices[0]
        # The tp group (None: one device, whole trees).
        self.mesh = self.devices if len(self.devices) > 1 else None
        self.tp = len(self.devices)
        if self.mesh is not None and hasattr(cfg, "n_experts"):
            raise TpUnsupportedError("a mixture-of-experts config")
        self.qos = qos
        # Per-slot adapter pool ids live in a host numpy vector with a
        # dirty-tracked device copy (the block table's idiom) and ride
        # every program as data.
        self.adapters = adapters
        self.adapter_ids: Optional[np.ndarray] = None
        self._aid_dev: Optional[torch.Tensor] = None
        self._aid_dirty = True
        # Composition {adapter name: slots} of the last decode or verify
        # dispatch (base-model slots are not counted).
        self.adapter_mix: Dict[str, int] = {}
        if adapters is not None:
            if adapters.device != self.device:
                adapters.pool = _to_device(adapters.pool, self.device)
            self.adapter_ids = np.zeros((n_slots,), np.int64)
        if self.mesh is not None:
            params = self._split(params, llama.param_logical_axes(cfg))
            if qweights is not None:
                qweights = self._split(qweights,
                                       kvcache.qweight_logical_axes(cfg))
        else:
            params = _to_device(params, self.device)
            if qweights is not None:
                qweights = _to_device(qweights, self.device)
        if qweights is None and weights_int8:
            if hasattr(cfg, "n_experts"):
                raise NotImplementedError(
                    "weights_int8 is not supported for MoE configs yet")
            qweights = kvcache.quantize_weights(params, cfg)
        # w8a8: no float copy of the block matrices or the head stays
        # resident (the caller drops its own reference to the float tree).
        self.qweights = qweights
        self.params = (kvcache.slim_params(params) if qweights is not None
                       else params)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.buckets = tuple(b for b in prompt_buckets if b <= max_len)
        # Admission wave cap: a burst of N requests prefills as
        # ceil(N/max_wave) device calls, so early waves' first tokens
        # land while later waves prefill. <= 0 means uncapped.
        self.max_wave = max_wave if max_wave and max_wave > 0 else None
        self.sampling_params = sampling_params
        self.eos_id = eos_id
        self.plain_attention = plain_attention
        # Chunked prefill: prompts longer than ``prefill_chunk`` prefill
        # in chunks of that many tokens, alternating with decode bursts.
        # 0 or None disables it.
        self.prefill_chunk = (prefill_chunk
                              if prefill_chunk and prefill_chunk > 0
                              else None)
        # Prefix reuse rides the chunk path (a hit prefills the suffix
        # through the chunk program), so it needs chunking.
        self.prefix_pool = (max(prefix_pool, 0)
                            if self.prefill_chunk else 0)
        self._prefix_index = (PrefixIndex(self.prefix_pool,
                                          self.prefill_chunk)
                              if self.prefix_pool else None)
        # Greedy-exact only: verification preserves argmax output, not a
        # sampled stream.
        spec_k = max(0, min(int(spec_k), 16))
        if sampling_params.temperature > 0.0:
            spec_k = 0
        self.spec_k = spec_k
        # The per-request drafter factory (the n-gram rung, and the
        # demotion target below the model rung).
        self._spec_drafter_factory = (
            spec_drafter if spec_drafter is not None
            else (lambda req: NGramDrafter(req.prompt)))
        # The model rung: K tokens per slot per round from the draft
        # model's staged burst, its paged KV advanced and rolled back in
        # lockstep with the verifier's commits.
        self.draft_engine = draft_engine
        # The async draft/verify pipeline: the next round's draft burst
        # is enqueued behind the verify calls, and its tokens are
        # checked against what the verify committed at the next round.
        if spec_pipeline is None:
            spec_pipeline = (
                os.environ.get("SKYTPU_SPEC_PIPELINE", "1") != "0")
        self.spec_pipeline = bool(spec_pipeline) and draft_engine is not None
        # Acceptance-collapse ladder: a request that has drafted at
        # least spec_min_drafted tokens below spec_min_rate acceptance
        # in its current rung demotes one rung.
        self.spec_min_drafted = 16
        self.spec_min_rate = 0.2
        # Counters the JAX engine keeps as metrics: copy-on-write block
        # copies, prefix hits/misses/evictions, drafted and accepted
        # tokens, verify program calls.
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        self.verify_calls = 0
        if kv_block is None:
            kv_block = int(os.environ.get("SKYTPU_KV_BLOCK", "256") or 0)
        self.paged = kv_block > 0
        self._table_dev: Optional[torch.Tensor] = None
        self._table_dirty = self.paged
        if self.paged:
            b = paged_block_len(max_len, kv_block, self.device, kv_int8)
            self.kv_block: Optional[int] = b
            nb = max_len // b
            self.n_kv_blocks = (kv_blocks if kv_blocks and kv_blocks > 0
                                else n_slots * nb)
            if self.n_kv_blocks < nb:
                raise ValueError(
                    f"kv_blocks={self.n_kv_blocks} cannot hold one "
                    f"max_len request ({nb} blocks of {b})")
            self.blocks_per_slot = nb
            self.allocator: Optional[kvcache.BlockAllocator] = (
                kvcache.BlockAllocator(self.n_kv_blocks))
            # Per-slot block table, one extra column pinned to the
            # sentinel (== n_kv_blocks, the cache's trash block). Host
            # numpy is authoritative; a cached device copy rides into
            # every program.
            self.block_table: Optional[np.ndarray] = np.full(
                (n_slots, nb + 1), self.n_kv_blocks, np.int32)
            self.cache = self._per_shard(
                lambda dev, G: kvcache.init_paged_cache(
                    cfg, n_slots, self.n_kv_blocks, self.kv_block, dev,
                    kv_int8=kv_int8, kv_heads=G))
        else:
            # Contiguous: one max_len row per slot plus the trash slot
            # (the reference's spare slot's bytes); no table, no
            # allocator.
            self.kv_block = None
            self.n_kv_blocks = 0
            self.blocks_per_slot = 0
            self.allocator = None
            self.block_table = None
            self.cache = self._per_shard(
                lambda dev, G: kvcache.init_cache(
                    cfg, n_slots, max_len, kv_int8=kv_int8, device=dev,
                    kv_heads=G))
        # The contiguous layout's prefix cache: a separate pool of
        # ``prefix_pool`` max_len rows, copied whole on store and hit. A
        # paged engine needs none: a stored prefix is shared blocks.
        self.pool = (self._per_shard(
            lambda dev, G: kvcache.init_prefix_pool(
                cfg, self.prefix_pool, max_len, kv_int8=kv_int8,
                device=dev, kv_heads=G))
            if self.prefix_pool and not self.paged else None)
        # K1 reads a paged cache whether or not kv_kernel is asked for;
        # a contiguous cache has no block table for it to walk, and the
        # request is answered with the reference's typed event.
        if kv_kernel is None:
            kv_kernel = os.environ.get("SKYTPU_KV_KERNEL", "") == "1"
        if kv_kernel and not self.paged:
            tracing.add_event("engine.kv_kernel_fallback",
                              {"reason": "contiguous_layout"}, echo=True)
        # Span-bucketed decode attention: each burst reads only the
        # first ``span`` logical rows of the rung covering its slots.
        self.span_ladder = _span_ladder(span_buckets, max_len)
        if draft_engine is not None and (
                draft_engine.n_slots != n_slots
                or draft_engine.cache["k"].device
                != sharding.shards_of(self.cache)[0]["k"].device):
            raise ValueError(
                f"draft engine of {draft_engine.n_slots} slots on "
                f"{draft_engine.device} for an engine of {n_slots} slots "
                f"on {self.device}: slot s of the drafter mirrors slot s")
        # Lazy per-burst block growth: admission reserves the context
        # plus one burst of headroom instead of the full token budget;
        # the rest allocates at burst dispatch (_ensure_headroom).
        if kv_lazy is None:
            kv_lazy = os.environ.get("SKYTPU_KV_LAZY", "") == "1"
        self.kv_lazy = bool(kv_lazy) and self.paged
        self._lazy_headroom = max(16, self.spec_k + 1)
        # Per-tenant KV-block charges: a slot's table references are
        # charged to its tenant at claim and growth, refunded at free.
        self._slot_kv_charge: Dict[int, Tuple[str, int]] = {}
        self._tenant_kv: Dict[str, int] = {}
        KV_BLOCKS_TOTAL.set(self.n_kv_blocks)
        SLOTS_TOTAL.set(n_slots)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.free_slots: List[int] = list(range(n_slots))
        self.slot_req: Dict[int, Request] = {}
        self.waiting: Deque[Request] = collections.deque()
        self.chunking: Deque[_ChunkState] = collections.deque()
        self.finished: List[Request] = []
        self._next_rid = 0
        # Requests the admission pass in progress has popped off
        # ``waiting`` and not yet landed where :meth:`recover` looks.
        self._admit_limbo: List[Request] = []
        # Tokens dispatched to the device but not yet committed
        # host-side (one outstanding burst at a time; caps the next).
        self._inflight_tokens = 0
        self._init_observability(flight_recorder, forensics,
                                 exemplar_store)

    # -- tensor parallelism ------------------------------------------------

    def _split(self, tree, logical_tree):
        """``tree`` split over the tp group (kept as it is when it is
        split over the group already)."""
        if isinstance(tree, sharding.Shards):
            if [_tree_device(t) for t in tree] != self.devices:
                raise ValueError("a split tree on other devices than the "
                                 "tp group's")
            return tree
        return sharding.split_tree(tree, logical_tree, self.devices)

    def _per_shard(self, make):
        """``make(device, kv_heads)`` for each shard of the tp group, as
        :class:`sharding.Shards` (the one tree without a group); the
        weights' split has checked that tp divides the kv heads."""
        G = self.cfg.n_kv_heads
        if self.mesh is None:
            return make(self.device, G)
        return sharding.Shards(make(d, G // self.tp) for d in self.devices)

    @staticmethod
    @torch.no_grad()
    def sharded_init(cfg: llama.LlamaConfig,
                     mesh: Sequence[DeviceLike], seed: int = 0
                     ) -> sharding.Shards:
        """Random parameters (``llama.init_params``' distributions, in
        ``cfg.dtype``, as serving draws them) drawn straight into their
        shards over the tp group ``mesh``: one layer of one weight at a
        time from a generator on the first device seeded with ``seed``,
        each shard's slice copied to its device, so no device ever holds
        the whole tree. The draws follow ``init_params``' order and are
        cut only between rows, so on the CPU, where a draw continues
        the stream of a longer one, the result is the split of
        ``init_params`` from the same seed. CUDA's generator advances by
        launch, so on a card the values differ from one whole draw, the
        distributions not. Pass the result with the same ``mesh`` to
        :class:`InferenceEngine`."""
        devices = [resolve_device(d) for d in mesh]
        dtype = cfg.dtype
        axes = llama.param_logical_axes(cfg)
        gen = torch.Generator(device=devices[0])
        gen.manual_seed(seed)
        d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

        def draw(shape, std, ax):
            """A [shape] weight drawn in blocks of whole rows (at most
            ~2**26 values a block), each block's shard slices copied to
            their devices; a weight split along its rows draws each
            shard's rows in turn."""
            n = len(devices)
            step = max(1, (1 << 26) // math.prod(shape[1:]))

            def rows(a, b):
                return torch.randn((b - a,) + tuple(shape[1:]),
                                   generator=gen, device=devices[0],
                                   dtype=dtype).mul_(std)

            if sharding.tp_dim(ax) == 0:
                if shape[0] % n:
                    raise ValueError(f"tp {n} does not divide the "
                                     f"{shape[0]} rows of {ax}")
                R = shape[0] // n
                return [torch.cat([rows(a, min(a + step, R)).to(dev)
                                   for a in range(0, R, step)])
                        for dev in devices]
            parts = [[] for _ in devices]
            for a in range(0, shape[0], step):
                blk = rows(a, min(a + step, shape[0]))
                for r, part in enumerate(sharding.split_tensor(
                        blk, (None,) + tuple(ax[1:]), devices)):
                    parts[r].append(part)
            return [torch.cat(ps) for ps in parts]

        def ones(shape):
            return [torch.ones(shape, device=dev, dtype=dtype)
                    for dev in devices]

        blocks = {"ln1": ones((L, d)), "ln2": ones((L, d))}
        embed = draw((v, d), 0.02, axes["embed"])
        for name, shape, std in (
                ("wq", (L, d, nh, hd), d ** -0.5),
                ("wk", (L, d, nkv, hd), d ** -0.5),
                ("wv", (L, d, nkv, hd), d ** -0.5),
                ("wo", (L, nh, hd, d), (nh * hd) ** -0.5),
                ("w_gate", (L, d, ff), d ** -0.5),
                ("w_up", (L, d, ff), d ** -0.5),
                ("w_down", (L, ff, d), ff ** -0.5)):
            blocks[name] = draw(shape, std, axes["blocks"][name])
        final = ones((d,))
        head = (draw((d, v), d ** -0.5, axes["lm_head"])
                if not cfg.tie_embeddings else None)
        out = sharding.Shards()
        for r in range(len(devices)):
            p = {"embed": embed[r],
                 "blocks": {k: w[r] for k, w in blocks.items()},
                 "final_norm": final[r]}
            if head is not None:
                p["lm_head"] = head[r]
            out.append(p)
        return out

    def _wire_shape(self, name: str) -> Tuple[int, ...]:
        """A cache array's shape with every kv head (the handoff wire's,
        whatever the tp degree)."""
        cache0 = sharding.shards_of(self.cache)[0]
        shape = list(cache0[name].shape)
        shape[sharding.tp_dim(kvcache.cache_logical_axes(cache0)[name])] \
            *= self.tp
        return tuple(shape)

    # -- observability -----------------------------------------------------

    def _init_observability(self, flight_recorder, forensics,
                            exemplar_store) -> None:
        """The reference engine's observability members: the flight
        recorder, the compile watch over every dispatch site (with the
        reference's program names and static keys), the device-time
        calibrator, the HBM ledger and roofline, and forensics."""
        # Decode-side program keys actually dispatched ((kind, width,
        # span) tuples; span None = the full view): the coverage checks
        # hold the flight records' program identities to this set.
        self.decode_programs: set = set()
        self.flight = (flight_recorder if flight_recorder is not None
                       else flight_lib.RECORDER)
        self.compile_watch = flight_lib.CompileWatch()
        # Every Nth dispatch of a program key (SKYTPU_DEVTIME_EVERY) is
        # bracketed with CUDA events on the card: the dev_ms_est column.
        self.devtime = attribution_lib.DeviceTimeCalibrator(
            device=self.device)
        self.compile_watch.calibrator = self.devtime
        # Per-burst attribution accumulators (loop thread): COW copies,
        # prefix evictions and lazy grows since the previous record.
        self._fl_cow = 0
        self._fl_evictions = 0
        self._fl_lazy_grows = 0
        if forensics is None:
            forensics = forensics_lib.forensics_enabled()
        self.forensics = bool(forensics)
        self.tail = forensics_lib.TailDetector()
        self.exemplars = (exemplar_store if exemplar_store is not None
                          else forensics_lib.EXEMPLARS)
        # The reference's "kernel" static argument: whether the
        # big-cache reads run K1 (the plain versions otherwise; a
        # contiguous cache always takes the gather).
        self._kernel = not self.plain_attention and self.paged
        watch = self.compile_watch.wrap
        # A wave's program key carries its real row count: the port
        # dispatches each wave at its own size.
        self._admit_wave_fn = watch(
            "admit_wave", self._admit_wave_program, ("bucket",),
            key_fn=lambda a, kw: (("rows", a[0].shape[0]),))
        self._decode_fn = watch("decode1", self._decode_program, ("span",))
        self._decode_burst_fn = watch(
            "decode_burst", self._decode_burst_program,
            ("k", "span", "kernel"))
        self._verify_fn = watch("verify", self._verify_program,
                                ("k", "span", "kernel"))
        self._prefill_chunk_fn = watch(
            "prefill_chunk", self._prefill_chunk_program,
            ("final", "span", "kernel"))
        self._claim_fn = watch("claim", kvcache.claim_slot)
        self._pool_load_fn = watch("pool_load", kvcache.pool_load)
        self._pool_store_fn = watch("pool_store", kvcache.pool_store)
        self._copy_block_fn = watch("copy_block", kvcache.copy_block)
        self._export_blocks_fn = watch("export_blocks",
                                       kvcache.export_blocks)
        self._import_blocks_fn = watch("import_blocks",
                                       kvcache.import_blocks)
        self._adapter_install_fn = watch("adapter_load",
                                         adapters_lib.pool_install)
        if self.adapters is not None:
            self.adapters.bind_loader(self._adapter_install_fn)
        # HBM ledger + roofline: KV bytes per token from the cache's
        # actual dtypes (int8 KV counts its bfloat16 scales). The
        # roofline costs the whole model; the ledger counts what one
        # shard of a tp group holds (its kv heads, its weight slices and
        # the replicated norms), each shard the same.
        cfg = self.cfg
        G, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
        cache0 = sharding.shards_of(self.cache)[0]
        self._kv_token_bytes = 2 * L * G * hd * cache0["k"].element_size()
        if "k_scale" in cache0:
            self._kv_token_bytes += (2 * L * G
                                     * cache0["k_scale"].element_size())
        self._kv_block_bytes = (self._kv_token_bytes * self.kv_block
                                if self.paged else 0)
        self._weight_bytes = (attribution_lib.tensor_bytes(self.params)
                              + attribution_lib.tensor_bytes(self.qweights))
        self.hbm_ledger = attribution_lib.HbmLedger()
        self.roofline = _roofline(cfg, self._weight_bytes,
                                  self._kv_token_bytes, self.max_len,
                                  self.prefill_chunk)
        # The draft model's rollouts cost at ITS scale.
        self._draft_roofline = None
        de = self.draft_engine
        if de is not None:
            d_kvt = (2 * de.cfg.n_layers * de.cfg.n_kv_heads
                     * de.cfg.head_dim * de.cache["k"].element_size())
            if "k_scale" in de.cache:
                d_kvt += (2 * de.cfg.n_layers * de.cfg.n_kv_heads
                          * de.cache["k_scale"].element_size())
            self._draft_roofline = _roofline(
                de.cfg, attribution_lib.tensor_bytes(de.params)
                + attribution_lib.tensor_bytes(de.qweights), d_kvt,
                de.max_len, None)
        peak_flops, peak_bw = attribution_lib.device_peaks(self.device)
        attribution_lib.ROOFLINE_PEAK_FLOPS.set(peak_flops)
        attribution_lib.ROOFLINE_PEAK_BW.set(peak_bw)
        self._init_hbm_ledger()

    def _init_hbm_ledger(self) -> None:
        """Static ledger components: what each tensor family holds for
        the engine's lifetime (storage sizes, no device fetch). The
        workspace entry is the reference's activation estimate for the
        widest admission wave (rows x bucket x (ff + 2d) fp32 plus the
        wave logits)."""
        led = self.hbm_ledger
        # Paged: prefixes share blocks; contiguous: the prefix_pool rows.
        for family, n in self.shard_bytes().items():
            led.set_bytes(family, n)
        led.set_bytes("draft_pool",
                      self.draft_engine.hbm_bytes()
                      if self.draft_engine is not None else 0)
        led.set_bytes("adapter_pool",
                      attribution_lib.tensor_bytes(self.adapters.pool)
                      if self.adapters is not None else 0)
        rows = (self.max_wave or self.n_slots) + 1
        widest = max(self.buckets) if self.buckets else self.max_len
        cfg = self.cfg
        led.set_bytes("workspace",
                      rows * widest * (cfg.d_ff + 2 * cfg.d_model) * 4
                      + rows * cfg.vocab_size * 4)
        stats = led.cross_check(self.device)
        if stats is None:
            # No device truth (the CPU): the limit comes from the
            # operator, else the analytical total plus slack.
            env = os.environ.get("SKYTPU_HBM_LIMIT_BYTES", "")
            try:
                limit = int(env) if env else 0
            except ValueError:
                limit = 0
            led.set_limit(limit if limit > 0 else int(led.total() * 1.25))
        self._refresh_hbm_ledger()

    def shard_bytes(self) -> Dict[str, int]:
        """Bytes each shard of the tp group holds, by family (the whole
        engine without a group): ``weights`` (float and int8), ``kv_pool``
        and ``prefix_pool``. Storage sizes, no device fetch."""
        def one(tree):
            return (attribution_lib.tensor_bytes(sharding.shards_of(tree)[0])
                    if tree is not None else 0)
        return {"weights": one(self.params) + one(self.qweights),
                "kv_pool": one(self.cache), "prefix_pool": one(self.pool)}

    def _refresh_hbm_ledger(self) -> None:
        """Occupancy components from the host bookkeeping admission runs
        on (allocator counts, prefix payloads): a ledger leak is a
        structure leak."""
        led = self.hbm_ledger
        idx = self._prefix_index
        block_bytes = self._kv_block_bytes // self.tp     # one shard's
        if not self.paged:
            # Contiguous: every active slot rents a whole max_len row, and
            # every resident prefix a pool row.
            row_bytes = self.max_len * self._kv_token_bytes // self.tp
            led.set_bytes("kv_used", len(self.slot_req) * row_bytes)
            led.set_bytes("prefix_pinned",
                          len(idx.payloads()) * row_bytes
                          if idx is not None else 0)
            return
        led.set_bytes("kv_used", self.allocator.used * block_bytes)
        pinned = 0
        if idx is not None:
            for payload in idx.payloads():
                pinned += len(payload) * block_bytes
        led.set_bytes("prefix_pinned", pinned)

    def _record_flight(self, burst: str, begin_s: float, end_s: float,
                       program: Dict[str, Any], slots, reqs,
                       toks: int, stall: bool = False,
                       drafted: int = 0, accepted: int = 0,
                       drafter: Optional[str] = None,
                       overlap_ms: float = 0.0,
                       dispatch_s: Optional[float] = None,
                       dev_keys: Optional[List[Optional[str]]] = None,
                       calibrator: Optional[
                           attribution_lib.DeviceTimeCalibrator]
                       = None) -> None:
        """Append one burst record (the reference's ``_record_flight``).
        Host bookkeeping only: every value already lives on the host.
        COW/eviction/lazy-grow attribution: whatever accumulated since
        the previous record rides this one."""
        cow, self._fl_cow = self._fl_cow, 0
        evs, self._fl_evictions = self._fl_evictions, 0
        lazy, self._fl_lazy_grows = self._fl_lazy_grows, 0
        compiled = self.compile_watch.drain_new()
        fl = self.flight
        if fl is None or not fl.enabled:
            return
        program = dict(program)
        program["layout"] = self._layout
        if burst in ("decode", "verify", "chunk", "decode1"):
            program["attn"] = "kernel" if self._kernel else "gather"
        extra: Dict[str, Any] = {}
        if stall:
            extra["stall"] = True
        if drafted:
            extra["drafted"] = drafted
            extra["accepted"] = accepted
        if drafter:
            extra["drafter"] = drafter
        if overlap_ms:
            extra["overlap_ms"] = overlap_ms
        if cow:
            extra["cow"] = cow
        if evs:
            extra["evictions"] = evs
        if lazy:
            extra["lazy_grows"] = lazy
        if compiled:
            extra["compiled"] = compiled
        dur_ms = max(end_s - begin_s, 0.0) * 1e3
        if dispatch_s is not None:
            disp_ms = min(max((dispatch_s - begin_s) * 1e3, 0.0), dur_ms)
            extra["dispatch_wall_ms"] = round(disp_ms, 4)
            extra["fetch_wall_ms"] = round(dur_ms - disp_ms, 4)
        cal = calibrator if calibrator is not None else self.devtime
        if dev_keys:
            ests = [cal.estimate(k) for k in dev_keys]
            ests = [e for e in ests if e is not None]
            if ests:
                # The counter takes the value the record carries (rounded
                # once), so a window's counter delta equals its records'
                # sum: the unrounded value parts from it by up to 5e-8 s
                # a record, and records of one key repeat their error.
                dev_ms = round(sum(ests) * 1e3, 4)
                extra["dev_ms_est"] = dev_ms
                attribution_lib.DEVICE_SECONDS.inc(dev_ms / 1e3)
        rl = self._draft_roofline if burst == "draft" else self.roofline
        if rl is not None:
            flops, hbm = rl.record_cost(burst, program, len(slots), toks)
            if flops:
                extra["flops"] = flops
                extra["hbm_bytes"] = hbm
                attribution_lib.DEVICE_FLOPS.inc(flops)
                attribution_lib.DEVICE_HBM_MOVED.inc(hbm)
        if self.adapters is not None and reqs:
            ads: Dict[str, int] = {}
            for r in reqs:
                if r.adapter:
                    ads[r.adapter] = ads.get(r.adapter, 0) + 1
            if ads:
                extra["adapters"] = ads
        if self.qos is not None and reqs:
            tenants: Dict[str, int] = {}
            for r in reqs:
                tenants[r.tenant] = tenants.get(r.tenant, 0) + 1
            extra["tenants"] = tenants
            if any(r.priority for r in reqs):
                prios: Dict[str, int] = {}
                for r in reqs:
                    prios[str(r.priority)] = prios.get(str(r.priority),
                                                       0) + 1
                extra["priorities"] = prios
        fl.record(
            burst, ts_s=begin_s, dur_s=max(end_s - begin_s, 0.0),
            program=program, slots=list(slots),
            rids=[r.rid for r in reqs],
            traces=[r.span_ctx.trace_id for r in reqs
                    if r.span_ctx is not None],
            toks=toks, **extra)

    def _record_event(self, burst: str, slots, rids, **fields) -> None:
        """A zero-duration record (preempt, recover, retire)."""
        fl = self.flight
        if fl is not None and fl.enabled:
            fl.record(burst, ts_s=fields.pop("ts_s", time.time()),
                      dur_s=0.0,
                      program=dict(fields.pop("program", {}),
                                   layout=self._layout),
                      slots=list(slots), rids=list(rids), toks=0,
                      **fields)

    def declare_warmup_complete(self) -> None:
        """Arm the compile watch: every program the live workload can
        reach is believed dispatched once, so a later new key is a shape
        the warm-up never ran (a typed ``engine.unexpected_compile``
        event and ``skytpu_unexpected_compiles_total``). The drafter's
        programs are part of the replica's surface and arm with it."""
        self.compile_watch.declare_warm()
        if self.draft_engine is not None:
            self.draft_engine.declare_warmup_complete()

    def warm_programs(self, max_burst: int = 8) -> int:
        """Dispatch every reachable program key once before traffic
        (then :meth:`declare_warmup_complete`): the single step and each
        decode burst width (powers of two up to ``max_burst``), verify,
        both chunk kinds at every span rung, an admission wave per
        bucket and row count, and the claim, block-copy, export/import
        (paged) or pool load/store (contiguous) and adapter-install
        programs, each once.

        The port keeps no spare slot, so every program runs against a
        free slot whose table row is all-sentinel (its writes land in
        the trash block; contiguous: any free slot, whose rows are
        dead); other slots ride inactive, their writes past their
        lengths as in any span group's burst. The pool programs copy
        pool row 0 into the free slot and back, so no resident prefix
        changes. Lengths, pending
        tokens and the generator's stream are restored afterwards, so no
        greedy token changes and no block is allocated. Raises
        :class:`NoFreeSlotError` when every slot is occupied. Runs under
        ``metrics.suppress``, then republishes the sweep's compile
        metrics from the watch registry. Returns the keys first
        dispatched (the drafter's included)."""
        spare = warm_slot(self.free_slots, self.block_table,
                          self.n_kv_blocks)
        before = self.compile_watch.count
        active = np.zeros((self.n_slots,), bool)
        active[spare] = True
        active_dev = upload(active, self.device)
        table = self.table_device()
        with warm_sweep(self.compile_watch, self.cache, self.generator):
            for span in self.span_ladder:
                sarg = self._span_arg(span)
                self._decode_fn(active_dev, table, span=sarg)
                k = 1
                while k <= max_burst:
                    self._decode_burst_fn(active_dev, table, k=k,
                                          span=sarg, kernel=self._kernel)
                    k *= 2
                if self.spec_k:
                    zeros = np.zeros((self.n_slots, self.spec_k),
                                     np.int64)
                    self._verify_fn(
                        upload(zeros, self.device),
                        upload(np.zeros((self.n_slots,), np.int64),
                               self.device), active_dev, table,
                        k=self.spec_k, span=sarg, kernel=self._kernel)
                if self.prefill_chunk:
                    chunk = upload(np.zeros((self.prefill_chunk,),
                                            np.int64), self.device)
                    for final in (False, True):
                        self._prefill_chunk_fn(
                            chunk, 0, 1, spare, self.max_len, table,
                            final=final, span=sarg,
                            kernel=self._kernel)
            cap = min(self.max_wave or self.n_slots, self.n_slots)
            for bucket in self.buckets:
                for rows in range(1, cap + 1):
                    self._admit_wave_fn(
                        upload(np.ones((rows, bucket), np.int64),
                               self.device),
                        upload(np.ones((rows,), np.int64), self.device),
                        [spare] * rows,
                        np.zeros((rows,), np.int64)
                        if self.adapters is not None else None,
                        table, bucket=bucket)
            self._claim_fn(self.cache, spare, self.max_len)
            if self.pool is not None:
                self._pool_load_fn(self.cache, self.pool, 0, spare,
                                   self.max_len)
                self._pool_store_fn(self.pool, self.cache, spare, 0)
            if self.paged:
                trash = self.n_kv_blocks
                self._copy_block_fn(self.cache, trash, trash)
                ids = torch.full((self.blocks_per_slot,), trash,
                                 dtype=torch.long, device=self.device)
                self._import_blocks_fn(
                    self.cache, ids,
                    self._export_blocks_fn(self.cache, ids))
            if self.adapters is not None:
                # The all-zero weights into the base slot (values
                # unchanged): a demand load mid-traffic dispatches a
                # program the warm-up ran.
                self.adapters.pool = self._adapter_install_fn(
                    self.adapters.pool, 0, self.adapters.zero_weights())
        n = self.compile_watch.count - before
        if self.spec_k and self.draft_engine is not None:
            n += self.draft_engine.warm_programs(self.spec_k)
        return n

    # -- the dispatch sites (each wrapped by the compile watch) -------------

    def _admit_wave_program(self, tokens: torch.Tensor, lens: torch.Tensor,
                            slots: List[int], aid: Optional[np.ndarray],
                            table: torch.Tensor, *, bucket: int
                            ) -> torch.Tensor:
        """One wave's prefill, first-token sample and inserts; returns
        the first tokens on the device, unfetched. ``aid``: each wave
        row's adapter pool slot (None on the adapterless path)."""
        wave_lora = {}
        if aid is not None:
            wave_lora = {"lora": self.adapters.pool,
                         "aid": upload(aid, self.device)}
        prefix, logits = kvcache.prefill_batch(
            self.params, tokens, lens, self.cfg,
            plain_attention=self.plain_attention, qweights=self.qweights,
            **wave_lora)
        first = sampling.sample(logits, self.sampling_params,
                                self.generator)
        for w, slot in enumerate(slots):
            kvcache.insert(self.cache, kvcache.wave_row(prefix, w), slot,
                           lens[w], first[w], table)
        return first

    def _decode_program(self, active: torch.Tensor,
                        table: Optional[torch.Tensor], *,
                        span: Optional[int]) -> torch.Tensor:
        """The single step: one token for every slot
        (:func:`kvcache.decode_step`), sampled, committed on ``active``
        slots; returns the tokens on the device, unfetched."""
        logits = kvcache.decode_step(
            self.params, self.cache, self.cfg, table, span=span,
            plain_attention=not self._kernel, qweights=self.qweights,
            **self._lora_args())
        toks = sampling.sample(logits, self.sampling_params, self.generator)
        kvcache.commit_tokens(self.cache, toks, active)
        return toks

    def _decode_burst_program(self, active: torch.Tensor,
                              table: torch.Tensor, *, k: int,
                              span: Optional[int], kernel: bool
                              ) -> torch.Tensor:
        return kvcache.decode_burst_staged(
            self.params, self.cache, active, k, self.cfg,
            self.sampling_params, table, span=span,
            generator=self.generator, plain_attention=not kernel,
            qweights=self.qweights, **self._lora_args())

    def _verify_program(self, draft: torch.Tensor, n_draft: torch.Tensor,
                        active: torch.Tensor, table: torch.Tensor, *,
                        k: int, span: Optional[int], kernel: bool):
        return kvcache.verify_draft_staged(
            self.params, self.cache, draft, n_draft, active, k, self.cfg,
            table, span=span, plain_attention=not kernel,
            qweights=self.qweights, **self._lora_args())

    def _prefill_chunk_program(self, chunk: torch.Tensor, start: int,
                               n_valid: int, slot: int, new_len: int,
                               table: torch.Tensor, *, final: bool,
                               span: Optional[int], kernel: bool):
        return kvcache.prefill_chunk(
            self.params, self.cache, chunk, start, n_valid, slot, new_len,
            self.cfg, self.sampling_params, table, final=final, span=span,
            generator=self.generator, plain_attention=not kernel,
            qweights=self.qweights, **self._lora_args())

    # -- requests ----------------------------------------------------------

    def add_request(self, prompt: List[int],
                    max_new_tokens: int = 128,
                    tenant: str = qos_lib.DEFAULT_TENANT,
                    priority: int = 0,
                    adapter: Optional[str] = None,
                    committed: Optional[List[int]] = None,
                    trace_ctx: Optional[tracing.SpanContext] = None
                    ) -> int:
        """Queue a request; returns its id. ``trace_ctx``: the caller's
        span (the HTTP ``traceparent``; None: the ambient context, else a
        fresh trace). ``tenant``/``priority``: its
        QoS identity (fair-scheduler lane, KV quota). ``adapter``: the
        fine-tune it generates under (None: the base model; an unknown
        name raises the typed 404 here). ``committed``:
        tokens another replica already committed (a KV handoff's decode
        tier): they are pre-seeded, so the request admits through the
        resume context (prompt + committed) and ``max_new_tokens`` still
        counts them."""
        _bucket(len(prompt), self.buckets)   # validate length up front
        self.check_kv_quota(tenant, len(prompt), max_new_tokens)
        self.check_adapter(adapter)
        req = Request(rid=self._next_rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      submit_s=time.time(), eos_id=self.eos_id,
                      tenant=tenant, priority=priority, adapter=adapter)
        if committed:
            req.tokens = [int(t) for t in committed]
        # Span identity minted at submit, so child spans recorded before
        # retirement parent to it; the loop thread has no ambient
        # context, so the caller's rides in explicitly.
        parent = trace_ctx if trace_ctx is not None else tracing.current()
        req.span_ctx = tracing.SpanContext(
            parent.trace_id if parent else tracing.new_trace_id(),
            tracing.new_span_id())
        req.parent_id = parent.span_id if parent else None
        self._next_rid += 1
        self.waiting.append(req)
        ENGINE_WAITING.set(len(self.waiting))
        return req.rid

    def _update_gauges(self) -> None:
        SLOTS_ACTIVE.set(len(self.slot_req))
        ENGINE_WAITING.set(len(self.waiting))
        seen = self.prefix_hits + self.prefix_misses
        if seen:
            PREFIX_HIT_RATIO.set(self.prefix_hits / seen)
        if self.paged:
            KV_BLOCKS_USED.set(self.allocator.used)
        self._refresh_hbm_ledger()

    @property
    def _layout(self) -> str:
        """The layout name program keys and flight records carry."""
        return "paged" if self.paged else "contig"

    def table_device(self) -> Optional[torch.Tensor]:
        """The block table as a device tensor, re-uploaded only after a
        claim or retirement changed it (None when contiguous)."""
        if not self.paged:
            return None
        if self._table_dirty or self._table_dev is None:
            self._table_dev = upload(self.block_table.copy(), self.device)
            self._table_dirty = False
        return self._table_dev

    def blocks_used(self) -> int:
        """Physical blocks referenced (0 when contiguous)."""
        return self.allocator.used if self.paged else 0

    # -- adapter catalog ---------------------------------------------------

    def aid_device(self) -> Optional[torch.Tensor]:
        """The per-slot adapter-id vector as a device tensor (None
        without a catalog), re-uploaded only after a claim or retirement
        changed it."""
        if self.adapters is None:
            return None
        if self._aid_dirty or self._aid_dev is None:
            self._aid_dev = upload(self.adapter_ids.copy(), self.device)
            self._aid_dirty = False
        return self._aid_dev

    def _lora_args(self) -> Dict[str, Any]:
        """kwargs routing the adapter pool and per-slot ids into a
        decode-family program ({} on the adapterless path)."""
        if self.adapters is None:
            return {}
        return {"lora": self.adapters.pool, "aid": self.aid_device()}

    def check_adapter(self, name: Optional[str]) -> None:
        """Submit-time guard (server handler threads): an unknown
        fine-tune is a clean typed 404 before the request reaches the
        loop thread. An engine with no catalog knows no adapters."""
        if name is None:
            return
        if self.adapters is None:
            raise adapters_lib.UnknownAdapterError(name, [])
        self.adapters.check(name)

    def _acquire_adapter(self, req: Request) -> str:
        """Pin the request's fine-tune into the device pool at claim.
        Returns "ok" (``adapter_slot`` assigned, pin counted), "stall"
        (every pool slot pinned by in-flight requests: the caller steps
        the request aside until a retirement unpins one) or "failed"
        (the checkpoint did not load: the request is failed typed and
        consumed; it never falls through to the base weights)."""
        if self.adapters is None or req.adapter is None:
            req.adapter_slot = 0
            return "ok"
        try:
            slot = self.adapters.acquire(req.adapter)
        except (adapters_lib.AdapterLoadError,
                adapters_lib.UnknownAdapterError) as e:
            self._fail_request(req, e)
            return "failed"
        if slot is None:
            return "stall"
        req.adapter_slot = slot
        req.adapter_pinned = slot > 0
        return "ok"

    def _release_adapter(self, req: Request) -> None:
        """Drop the request's in-flight adapter pin (exactly once per
        acquire: retirement, preemption, or an abandoned claim)."""
        if req.adapter_pinned and self.adapters is not None:
            self.adapters.release(req.adapter_slot)
            req.adapter_pinned = False

    def _set_slot_adapter(self, slot: int, pool_slot: int) -> None:
        if self.adapters is None:
            return
        if self.adapter_ids[slot] != pool_slot:
            self.adapter_ids[slot] = pool_slot
            self._aid_dirty = True

    def _prefix_salt(self, req: Request) -> bytes:
        """The request's prefix-cache key namespace. Stored K/V rows
        carry the fine-tune's wk/wv deltas, so cached prefixes are
        adapter-specific: keyed by the adapter's CONTENT digest (warm
        prefixes survive evict/reload and alias names); base-model
        requests keep the empty salt, the key space of the load
        balancer's ``prefix_affinity_key``."""
        if self.adapters is None or not req.adapter_slot:
            return b""
        return self.adapters.slot_content(req.adapter_slot)

    def _fail_request(self, req: Request, exc: Exception) -> None:
        """Retire a request with a typed error instead of tokens (the
        adapter-load failure path). The server returns the body with
        the error's HTTP status."""
        req.error = getattr(exc, "typed_error", None) or {
            "type": "error", "message": str(exc)}
        if getattr(exc, "http_status", None):
            req.error = dict(req.error, http_status=exc.http_status)
        req.done = True
        self._end_stall(req)
        self.finished.append(req)

    def _note_adapter_mix(self, slots) -> None:
        """Record the adapters a decode or verify dispatch serves."""
        if self.adapters is None:
            return
        mix: Dict[str, int] = {}
        for slot in slots:
            name = self.slot_req[slot].adapter
            if name:
                mix[name] = mix.get(name, 0) + 1
        self.adapter_mix = mix

    # -- KV blocks ---------------------------------------------------------

    def _need_blocks(self, req: Request,
                     ctx_len: Optional[int] = None) -> int:
        """Blocks to reserve at admission. Eager (default): the worst
        case, prompt plus the full token budget capped by max_len, so
        decode never runs out of backing mid-flight (the formula is
        total-shaped, so a resume reserves the same). Lazy: the
        admission context (``ctx_len``, else the prompt) plus one burst
        of headroom; the rest grows per burst in
        :meth:`_ensure_headroom`."""
        need = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        if self.kv_lazy:
            base = ctx_len if ctx_len is not None else len(req.prompt)
            need = min(base + self._lazy_headroom, need)
        return -(-need // self.kv_block)

    def _ensure_headroom(self, slot: int, req: Request,
                         need_rows: int) -> bool:
        """Lazy mode: grow the slot's block allocation to back
        ``need_rows`` cache rows before a burst writes them (eager
        engines reserved the worst case at admission and always pass).
        Growth rides admission's dry-pool path (LRU prefix entries evict
        first); a pool that stays dry returns False and the slot sits
        this burst out, inactive, its device length unchanged."""
        if not self.kv_lazy:
            return True
        cap = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        need_rows = min(need_rows, cap)
        row = self.block_table[slot]
        have = len(row[row < self.n_kv_blocks])
        grow = -(-need_rows // self.kv_block) - have
        if grow <= 0:
            return True
        blocks = self._alloc_blocks(grow)
        if blocks is None:
            return False
        row[have:have + len(blocks)] = blocks
        self._table_dirty = True
        self._sync_kv_charge(slot, req.tenant)
        KV_LAZY_GROWS.inc(len(blocks))
        self._fl_lazy_grows += len(blocks)
        return True

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """n fresh blocks, evicting LRU prefix-cache entries on a dry
        pool (their blocks free unless still shared with live slots).
        None when the pool stays too dry: the caller leaves the request
        queued and admission retries after retirements. The ``kv.alloc``
        chaos point fires here, inside the enclosing dispatch seam."""
        chaos.point("kv.alloc", need=n)
        alloc = self.allocator
        idx = self._prefix_index
        while alloc.available < n and idx is not None:
            # Evict only an entry that would actually FREE a block: one
            # whose blocks are all shared with live slots (or pinned by
            # the claim in progress) frees nothing, and dropping it would
            # only lose the warm prefix.
            victim = next((p for p in idx.payloads_lru()
                           if any(alloc.ref(b) == 1 for b in p)), None)
            if victim is None:
                break
            idx.evict_entry(victim)
            self._count_eviction()
            for b in victim:
                alloc.decref(b)
        if alloc.available < n:
            return None
        return [alloc.alloc() for _ in range(n)]

    def _count_eviction(self) -> None:
        self.prefix_evictions += 1
        self._fl_evictions += 1
        PREFIX_EVICTIONS.inc()

    def _count_cow(self) -> None:
        self.cow_copies += 1
        self._fl_cow += 1
        KV_COW_COPIES.inc()

    # -- per-tenant KV-block quotas (qos max_kv_blocks) --------------------

    def _kv_quota(self, tenant: str) -> int:
        """The tenant's ``max_kv_blocks`` quota (0 = unlimited); only
        on a paged engine with a QoS config."""
        if not self.paged or self.qos is None:
            return 0
        return max(self.qos.cfg.tenant(tenant).max_kv_blocks, 0)

    def check_kv_quota(self, tenant: str, prompt_len: int,
                       max_new_tokens: int) -> None:
        """Submit-time guard: a request whose OWN worst-case block need
        exceeds its tenant's quota can never admit (the need never
        shrinks), so stalling it would hang the client forever: raise
        the typed error instead. Reads only engine constants, so the
        server's handler threads call it eagerly (a clean 400 before the
        request reaches the loop thread)."""
        quota = self._kv_quota(tenant)
        if not quota:
            return
        need = min(prompt_len + max_new_tokens, self.max_len)
        if self.kv_lazy:
            need = min(prompt_len + self._lazy_headroom, need)
        need = -(-need // self.kv_block)
        if need > quota:
            raise KvQuotaUnsatisfiableError(tenant, need, quota)

    def _kv_quota_blocked(self, req: Request) -> bool:
        """Admission-time quota check: True holds THIS request back (the
        stall counter fires once per episode) while other tenants keep
        admitting. The quota gates admission only: in-flight lazy growth
        is never blocked (it is still charged, which holds the tenant's
        next admission)."""
        quota = self._kv_quota(req.tenant)
        if not quota:
            return False
        need = self._need_blocks(req, self._ctx_len(req))
        used = self._tenant_kv.get(req.tenant, 0)
        if used + need <= quota:
            req.kv_quota_stalled = False
            if req.stall_cause == "kv_quota":
                self._end_stall(req)
            return False
        self._mark_stall(req, "kv_quota")
        if not req.kv_quota_stalled:
            req.kv_quota_stalled = True
            QOS_KV_QUOTA_STALLS.labels(
                tenant=qos_lib.tenant_label(req.tenant,
                                            self.qos.cfg)).inc()
        return True

    def _set_tenant_kv(self, tenant: str, n: int) -> None:
        # Entries pop at zero: tenant names are client-supplied.
        if n > 0:
            self._tenant_kv[tenant] = n
        else:
            self._tenant_kv.pop(tenant, None)
        # The gauge's label cap collapses overflow tenants into "other":
        # publish the label's sum, not this tenant's count.
        cfg = self.qos.cfg if self.qos is not None else None
        label = qos_lib.tenant_label(tenant, cfg)
        total = sum(v for t, v in self._tenant_kv.items()
                    if qos_lib.tenant_label(t, cfg) == label)
        QOS_KV_BLOCKS.labels(tenant=label).set(total)

    def _sync_kv_charge(self, slot: int,
                        tenant: Optional[str] = None) -> None:
        """Re-point the tenant accounting at the slot's CURRENT table
        occupancy (at claim, growth and free): the charge is the blocks
        the slot's table references, so shared prefix blocks charge every
        referencing tenant and the refund is exact by construction. A
        contiguous engine charges nothing."""
        if not self.paged:
            return
        old_tenant, old_n = self._slot_kv_charge.get(slot, (None, 0))
        tenant = tenant if tenant is not None else old_tenant
        row = self.block_table[slot]
        have = len(row[row < self.n_kv_blocks])
        if old_tenant is not None and old_n:
            self._set_tenant_kv(
                old_tenant, self._tenant_kv.get(old_tenant, 0) - old_n)
        if tenant is not None and have:
            self._slot_kv_charge[slot] = (tenant, have)
            self._set_tenant_kv(
                tenant, self._tenant_kv.get(tenant, 0) + have)
        else:
            self._slot_kv_charge.pop(slot, None)

    def _wave_claim(self, req: Request) -> Tuple[str, Optional[int]]:
        """Claim a slot, its KV blocks and the pin of its adapter.
        Returns ("ok", slot); ("dry", None) when the block pool is too
        dry (the caller re-queues and stalls admission); ("held", None)
        when every adapter-pool slot is pinned (the caller steps THIS
        request aside, as a quota hold does); ("failed", None) when the
        adapter failed to load (the request is failed typed)."""
        st = self._acquire_adapter(req)
        if st == "failed":
            return "failed", None
        if st == "stall":
            self._mark_stall(req, "adapter_pin")
            return "held", None
        if not self.paged:
            slot = self.free_slots.pop(0)
            self._set_slot_adapter(slot, req.adapter_slot)
            self._end_stall(req)
            return "ok", slot
        blocks = self._alloc_blocks(
            self._need_blocks(req, self._ctx_len(req)))
        if blocks is None:
            # The pin must not leak across the re-queue: the next pass
            # re-acquires (a resident adapter is a warm hit).
            self._release_adapter(req)
            self._mark_stall(req, "pool_dry")
            return "dry", None
        slot = self.free_slots.pop(0)
        row = self.block_table[slot]
        row[:] = self.n_kv_blocks
        row[:len(blocks)] = blocks
        self._table_dirty = True
        self._sync_kv_charge(slot, req.tenant)
        self._set_slot_adapter(slot, req.adapter_slot)
        self._end_stall(req)
        return "ok", slot

    def _free_slot_blocks(self, slot: int) -> None:
        """Release a slot's block references and clear its table row to
        the sentinel: later bursts' writes for the dead slot land in the
        trash block. A block a prefix entry still holds survives. A
        contiguous slot holds no blocks."""
        if not self.paged:
            return
        row = self.block_table[slot]
        for b in row[row < self.n_kv_blocks].tolist():
            self.allocator.decref(b)
        row[:] = self.n_kv_blocks
        self._table_dirty = True
        self._sync_kv_charge(slot)      # refund the tenant's charge

    # -- span buckets ------------------------------------------------------

    def _span_for(self, rows: int) -> int:
        """Smallest ladder rung covering ``rows`` cache rows."""
        for s in self.span_ladder:
            if rows <= s:
                return s
        return self.span_ladder[-1]

    def _span_arg(self, span: int) -> Optional[int]:
        """None selects the full view (the whole table)."""
        return None if span >= self.max_len else span

    def _slot_rows(self, req: Request) -> int:
        """Cache rows the slot holds at the next burst's start as the
        device will see it: committed tokens plus those in flight."""
        return (len(req.prompt) + len(req.tokens)
                + self._inflight_tokens)

    def _span_groups(self, width: int) -> List[Tuple[int, List[int]]]:
        """Active slots grouped by the span rung covering their rows,
        so one long conversation does not drag its short neighbours to
        its rung. Each group dispatches its own burst; a group's writes
        for other groups' slots land past their committed lengths and
        are overwritten before any read. ``width``: rows the burst will
        write per slot, which lazy growth must back; a slot the pool
        cannot grow is left out of every group (inactive in the burst,
        its device length unchanged) and retries once retirements free
        blocks. Ascending spans."""
        groups: Dict[int, List[int]] = {}
        for slot, req in self.slot_req.items():
            rows = self._slot_rows(req)
            if not self._ensure_headroom(slot, req, rows + width):
                continue
            groups.setdefault(self._span_for(rows), []).append(slot)
        return sorted(groups.items())

    # -- QoS: re-queue, stall episodes, preemption-by-eviction -------------

    def _mark_stall(self, req: Request, cause: str) -> None:
        """Open (or re-assert) an admission-stall episode on ``req``:
        idempotent per cause; a cause change closes the old episode into
        ``stall_ms`` and opens the new one."""
        now = time.time()
        if req.stall_cause is not None:
            if req.stall_cause == cause:
                return
            req.stall_ms[req.stall_cause] = (
                req.stall_ms.get(req.stall_cause, 0.0)
                + (now - req.stall_begin_s) * 1e3)
        req.stall_cause = cause
        req.stall_begin_s = now

    def _end_stall(self, req: Request) -> None:
        """Close an open stall episode (claim, quota unblock,
        retirement); no-op when none is open."""
        if req.stall_cause is None:
            return
        req.stall_ms[req.stall_cause] = (
            req.stall_ms.get(req.stall_cause, 0.0)
            + max(time.time() - req.stall_begin_s, 0.0) * 1e3)
        req.stall_cause = None
        req.stall_begin_s = 0.0

    def _requeue(self, req: Request) -> None:
        """THE re-queue path: every request going back to the queue head
        (dry-pool stall, chunk-claim stall, preemption) passes here, so
        the queue-depth gauge never goes stale."""
        self.waiting.appendleft(req)
        ENGINE_WAITING.set(len(self.waiting))

    def preempt_slot(self, slot: int) -> bool:
        """Preemption-by-eviction of one decode slot.

        The victim's committed KV rows [0, prompt + tokens - 1) are the
        bytes its prefill and decode wrote; their chunk-aligned prefix
        retires into the prefix cache as ref-counted shared blocks
        (increfs only: the dying slot never writes again, so even a
        trailing partial block is shared without a copy). The slot's
        table row goes to the sentinel at once (``_free_slot_blocks``),
        and the device table is re-uploaded before the next dispatch, so
        the next burst's flush for the freed slot lands in the trash
        block, never in the shared block. The request re-queues with its
        tokens and resumes through the ordinary prefix-hit admission
        over its extended context (:meth:`_ctx`), re-prefilling only the
        sub-chunk tail: greedy output equals an unpreempted run's.

        Refuses while a dispatched burst is un-fetched (its completion
        would commit tokens into a request already back in the queue)
        and for contexts the engine could not re-admit through the chunk
        path (:meth:`_resumable`). Host bookkeeping only."""
        req = self.slot_req.get(slot)
        if req is None or self._inflight_tokens:
            return False
        ctx = req.prompt + req.tokens
        if not self._resumable(len(ctx)):
            return False
        retired_rows = 0
        # A contiguous victim resumes cold: its rows would have to be
        # copied into a pool row, and the reference stores none.
        if self.paged and self._prefix_index is not None and req.n_chunks:
            # Committed rows stop one short of the context: the last
            # token's row is written by the burst that decodes its
            # successor, which never ran. Only a chunk-admitted victim's
            # rows may enter the shared cache (it promises chunk-program
            # bytes to every sharer); a wave-admitted victim resumes
            # cold.
            self._store_prefix(ctx, slot, len(ctx) - 1, donor_live=False,
                               salt=self._prefix_salt(req))
            # The record reports what the resume will read warm: the
            # cached rows covering the context after the store.
            covered = self._prefix_index.lookup(ctx, self._prefix_salt(req))
            if covered is not None:
                retired_rows = covered[1]
        self.slot_req.pop(slot, None)
        self.free_slots.append(slot)
        self._free_slot_blocks(slot)
        self._set_slot_adapter(slot, 0)
        if self.draft_engine is not None:
            # The resume's draft slot re-ingests its context.
            self.draft_engine.release(slot)
        # The resume re-acquires its adapter at the next claim.
        self._release_adapter(req)
        req.slot = None
        req.preemptions += 1
        qos_lib.QOS_PREEMPTIONS.labels(
            tenant=qos_lib.tenant_label(
                req.tenant,
                self.qos.cfg if self.qos is not None else None)).inc()
        self._record_event("preempt", [slot], [req.rid],
                           tenants={req.tenant: 1}, priority=req.priority,
                           retired_rows=retired_rows)
        self._requeue(req)
        self._update_gauges()
        return True

    def _preempt_for_waiting(self) -> bool:
        """For each queued request that outranks a running one and
        cannot get a free slot, evict the lowest-priority active slot
        (ties: the youngest, least sunk decode work). Runs before
        admission claims slots; victims re-queue behind the lanes that
        outrank them on the next reorder. Returns whether anything was
        evicted."""
        if self._inflight_tokens or not self.slot_req:
            return False
        evicted_any = False
        avail = len(self.free_slots)
        for w in list(self.waiting)[:self.n_slots]:
            if avail > 0:
                avail -= 1          # a free slot already covers it
                continue
            # Outranked residents, best victim first; a refusal (an
            # un-resumable context) falls through to the next one.
            candidates = sorted(
                (r.priority, -r.rid, slot)
                for slot, r in self.slot_req.items()
                if r.priority < w.priority)
            for _, _, slot in candidates:
                if self.preempt_slot(slot):
                    evicted_any = True
                    break
            else:
                break               # nothing outranked (or evictable)
        return evicted_any

    # -- admission ---------------------------------------------------------

    def admit(self, on_wave=None) -> None:
        """Prefill+insert every admissible waiting request. Prompts
        longer than ``prefill_chunk`` claim a slot and join the chunk
        queue instead (they never ride a wave). Waves group by prompt
        bucket (one long prompt must not drag co-admitted short prompts
        up to its bucket) and are capped at max_wave. All waves are
        dispatched first, then each wave's first tokens are fetched in
        order; ``on_wave`` fires as each wave's tokens land. A dry
        block pool stalls admission with the request back at the
        queue's head.

        With a fair scheduler the queue is first reordered into priority
        lanes and DRR order, outranked residents are evicted for queued
        higher-priority work, and the queue is reordered again (victims
        go behind the lanes that outrank them). A request whose tenant
        is at its KV quota steps aside for this pass while everyone
        behind it admits, and so does one whose adapter cannot load
        because every adapter-pool slot is pinned.

        The pass runs behind the ``admit`` dispatch boundary. Requests it
        had popped off the queue but not yet landed in ``chunking`` or
        ``slot_req`` go back to the queue's head before the error
        crosses the boundary, so :meth:`recover` sees them."""
        self._admit_limbo = []
        try:
            with _dispatch_boundary("admit"):
                self._admit_impl(on_wave)
        except EngineDispatchError:
            self._rescue_admit_limbo()
            raise

    def _rescue_admit_limbo(self) -> None:
        """Re-queue every request the crashed admission pass held in
        locals; one already reachable from ``waiting``, ``chunking``,
        ``slot_req`` or ``finished`` stays put (never a duplicate)."""
        reachable = {r.rid for r in self.waiting}
        reachable.update(st.req.rid for st in self.chunking)
        reachable.update(r.rid for r in self.slot_req.values())
        reachable.update(r.rid for r in self.finished)
        lost = [r for r in self._admit_limbo if r.rid not in reachable]
        self._admit_limbo = []
        for r in reversed(lost):     # the earliest pop back at the head
            self.waiting.appendleft(r)

    def _admit_impl(self, on_wave=None) -> None:
        if self.qos is not None and self.waiting:
            self.qos.reorder(self.waiting)
            if self._preempt_for_waiting() and self.waiting:
                self.qos.reorder(self.waiting)
        stalled = False
        quota_held: List[Request] = []
        limbo = self._admit_limbo

        def pop_waiting() -> Request:
            # Every pop is tracked until the request lands somewhere
            # recover() can see (_rescue_admit_limbo).
            req = self.waiting.popleft()
            limbo.append(req)
            return req

        while self.waiting and self.free_slots and not stalled:
            dispatched = []
            while self.waiting and self.free_slots and not stalled:
                if self._kv_quota_blocked(self.waiting[0]):
                    quota_held.append(pop_waiting())
                    continue
                if self._use_chunked(self.waiting[0]):
                    req = pop_waiting()
                    cst = self._claim_chunked(req)
                    if cst == "stall":
                        stalled = True
                    elif cst == "held":
                        quota_held.append(req)
                    continue
                bucket = _bucket(self._ctx_len(self.waiting[0]),
                                 self.buckets)
                wave: List[Request] = []
                slots: List[int] = []
                rest: List[Request] = []
                while self.waiting and self.free_slots and not stalled \
                        and (self.max_wave is None
                             or len(wave) < self.max_wave):
                    req = pop_waiting()
                    if self._kv_quota_blocked(req):
                        quota_held.append(req)
                    elif self._use_chunked(req):
                        cst = self._claim_chunked(req)
                        if cst == "stall":
                            stalled = True
                        elif cst == "held":
                            quota_held.append(req)
                    elif _bucket(self._ctx_len(req),
                                 self.buckets) != bucket:
                        rest.append(req)
                    else:
                        st, slot = self._wave_claim(req)
                        if st == "ok":
                            wave.append(req)
                            slots.append(slot)
                        elif st == "held":
                            # Adapter pool fully pinned: step aside,
                            # base and resident-adapter traffic behind
                            # it keeps admitting.
                            quota_held.append(req)
                        elif st == "dry":         # block pool dry
                            self._requeue(req)
                            stalled = True
                        # "failed": consumed (failed typed)
                self.waiting.extendleft(reversed(rest))
                if wave:
                    dispatched.append(
                        (wave, slots, bucket,
                         self._dispatch_wave(wave, slots, bucket)))
            for wave, slots, bucket, disp in dispatched:
                self._complete_wave(wave, slots, bucket, *disp)
                if on_wave is not None:
                    on_wave()
        if quota_held:
            self.waiting.extendleft(reversed(quota_held))
        self._update_gauges()

    def _dispatch_wave(self, wave: List[Request], slots: List[int],
                       bucket: int
                       ) -> Tuple[torch.Tensor, timeline.Event, bool,
                                  float, Optional[str]]:
        """Enqueue one wave's prefill + inserts; returns the first
        tokens as a device tensor, not yet fetched, the open prefill
        span (closed at completion: dispatch through first-token fetch,
        the latency a request experiences), whether decode slots were
        active (the wave then also counts as decode stall), when the
        dispatch returned, and its program key."""
        WAVE_SIZE.observe(len(wave))
        span = timeline.Event(
            "skytpu_prefill_seconds",
            histogram=PREFILL_SECONDS.labels(bucket=str(bucket)))
        span.begin()
        for req in wave:
            # Queue wait ends where the prefill dispatch begins.
            tracing.record_span(
                "engine.queue_wait", req.submit_s, span.begin_s,
                parent=req.span_ctx, attrs={"rid": req.rid})
        n = len(wave)
        tokens_b = np.zeros((n, bucket), np.int64)
        true_lens = np.ones((n,), np.int64)
        for i, req in enumerate(wave):
            ctx = self._ctx(req)
            tokens_b[i, :len(ctx)] = ctx
            true_lens[i] = len(ctx)
        decode_active = bool(self.slot_req)
        # Each wave row gathers its own fine-tune: mixed-adapter
        # admission is one call.
        aid = (np.array([r.adapter_slot for r in wave], np.int64)
               if self.adapters is not None else None)
        first = self._admit_wave_fn(
            upload(tokens_b, self.device), upload(true_lens, self.device),
            slots, aid, self.table_device(), bucket=bucket)
        return (first, span, decode_active, time.time(),
                self.compile_watch.last_key)

    def _complete_wave(self, wave: List[Request], slots: List[int],
                       bucket: int, first_dev: torch.Tensor,
                       span: timeline.Event, decode_active: bool = False,
                       dispatch_s: Optional[float] = None,
                       dev_key: Optional[str] = None) -> None:
        first = first_dev.tolist()             # host sync for THIS wave
        span.end()
        now = time.time()
        t0 = span.begin_s
        if decode_active:
            DECODE_STALL_SECONDS.observe(max(now - t0, 0.0))
        self._record_flight(
            "wave", begin_s=t0, end_s=now,
            program={"bucket": bucket, "rows": len(first)},
            slots=slots, reqs=wave, toks=len(wave),
            stall=decode_active, dispatch_s=dispatch_s,
            dev_keys=[dev_key])
        for req in wave:
            # Dispatch through first-token fetch: the latency the
            # request experienced.
            tracing.record_span(
                "engine.prefill", t0, now, parent=req.span_ctx,
                attrs={"rid": req.rid, "bucket": bucket,
                       "cached_len": 0, "chunks": 0})
        for req, slot, tok in zip(wave, slots, first):
            req.slot = slot
            req.tokens.append(tok)
            if req.first_token_s is None:      # not a resume
                req.first_token_s = now
                TTFT_SECONDS.observe(max(now - req.submit_s, 0.0))
            PREFILL_REQUESTS.labels(bucket=str(bucket)).inc()
            self.slot_req[slot] = req
            if self._req_finished(req, tok):
                self._retire(req)

    # -- chunked prefill ---------------------------------------------------

    def _ctx(self, req: Request) -> List[int]:
        """A queued request's admission context: its prompt, extended by
        the tokens it already committed when it resumes (a KV handoff);
        the resume prefills (or prefix-cache-reuses) the whole context
        and the final chunk's sample is the next token."""
        if not req.tokens:
            return req.prompt
        return req.prompt + req.tokens

    def _ctx_len(self, req: Request) -> int:
        """``len(self._ctx(req))`` without building the list."""
        return len(req.prompt) + len(req.tokens)

    def _resumable(self, ctx_len: int) -> bool:
        """Whether a context of this length resumes through the chunk
        path, the only resume held token for token to an uninterrupted
        run (a wave would sample the next token from the wave program's
        logits where the uninterrupted run used the decode program's)."""
        if ctx_len >= self.max_len:
            return False
        return (self.prefill_chunk is not None
                and ctx_len > self.prefill_chunk)

    def _use_chunked(self, req: Request) -> bool:
        return (self.prefill_chunk is not None
                and self._ctx_len(req) > self.prefill_chunk)

    def _claim_chunked(self, req: Request) -> str:
        """Claim a slot for an incremental prefill: look up the prefix
        cache, map a hit's shared blocks into the slot's table row (no
        row copies; a partially filled shared block is copied on write
        first, since the suffix prefill writes into it), and queue the
        remaining chunks. The claim stamps the slot's length to max_len
        (:func:`kvcache.claim_slot`), so interleaved bursts' writes for
        this not-yet-active slot land in the trash block. A resume looks
        up and prefills its whole context (:meth:`_ctx`). Returns "ok";
        "stall" when the block pool is too dry (the request went back to
        the queue's head); "held" when every adapter-pool slot is pinned
        (the caller steps the request aside); "failed" when its adapter
        failed to load (failed typed, consumed)."""
        st = self._acquire_adapter(req)
        if st == "failed":
            return "failed"
        if st == "stall":
            self._mark_stall(req, "adapter_pin")
            return "held"
        ctx = self._ctx(req)
        idx = self._prefix_index
        salt = self._prefix_salt(req)
        hit = idx.lookup(ctx, salt) if idx is not None else None
        cached = n_shared = partial = 0
        shared: List[int] = []
        new_blocks: List[int] = []
        if hit is not None:
            payload, cached = hit
        if self.paged:
            if hit is not None:
                n_shared, partial = divmod(cached, self.kv_block)
                # Pin the shared blocks BEFORE any dry-pool eviction:
                # _alloc_blocks may evict the hit's own entry, and an
                # unpinned block could come straight back as a fresh
                # one, aliased at two table positions.
                shared = list(payload[:n_shared])
                for b in shared:
                    self.allocator.incref(b)
            # A lazy reservation can be smaller than the shared prefix
            # rounds to; never ask for a negative count.
            new_blocks = self._alloc_blocks(
                max(self._need_blocks(req, len(ctx)) - n_shared, 0))
            if new_blocks is None:
                for b in shared:              # unpin; retry next pass
                    self.allocator.decref(b)
                self._release_adapter(req)
                self._mark_stall(req, "pool_dry")
                self._requeue(req)
                return "stall"
        slot = self.free_slots.pop(0)
        self._set_slot_adapter(slot, req.adapter_slot)
        req.slot = slot
        self._end_stall(req)
        req.prefill_begin_s = time.time()
        tracing.record_span(
            "engine.queue_wait", req.submit_s, req.prefill_begin_s,
            parent=req.span_ctx, attrs={"rid": req.rid})
        if hit is not None:
            self.prefix_hits += 1
            PREFIX_HITS.inc()
        elif idx is not None and idx.eligible(ctx):
            self.prefix_misses += 1
            PREFIX_MISSES.inc()
        if not self.paged:
            # A hit copies the pool row into the slot; both claims stamp
            # the slot's length to max_len.
            if hit is not None:
                self._pool_load_fn(self.cache, self.pool, payload, slot,
                                   self.max_len)
            else:
                self._claim_fn(self.cache, slot, self.max_len)
        else:
            row = self.block_table[slot]
            row[:] = self.n_kv_blocks
            if hit is not None:
                row[:n_shared] = shared
                if partial:
                    # Copy the partial shared block before the suffix
                    # prefill writes into it (its owner keeps ref > 1).
                    self._copy_block_fn(self.cache, payload[n_shared],
                                        new_blocks[0])
                    self._count_cow()
            row[n_shared:n_shared + len(new_blocks)] = new_blocks
            self._table_dirty = True
            self._sync_kv_charge(slot, req.tenant)
            self._claim_fn(self.cache, slot, self.max_len)
        if req.tokens:
            req.resumed_len = cached
        else:
            req.cached_len = cached
        self.chunking.append(_ChunkState(req=req, pos=cached,
                                         total=len(ctx), ctx=ctx))
        self._update_gauges()
        return "ok"

    def prefill_chunk_step(self) -> bool:
        """Run ONE chunk of the head chunked prefill. The big-cache read
        covers the span rung of the chunk's offset. On the final chunk
        the request's first token is fetched (host sync), the slot joins
        the decoding slots, and the request may retire at once. Returns
        True if a chunk ran. Runs behind the ``chunk`` dispatch
        boundary."""
        if not self.chunking:
            return False
        with _dispatch_boundary("chunk"):
            return self._prefill_chunk_impl()

    def _prefill_chunk_impl(self) -> bool:
        st = self.chunking[0]
        req = st.req
        C = self.prefill_chunk
        start = st.pos
        n_valid = min(C, st.total - start)
        final = start + n_valid >= st.total
        chunk = np.zeros((C,), np.int64)
        chunk[:n_valid] = st.ctx[start:start + n_valid]
        decode_active = bool(self.slot_req)
        attn_span = self._span_arg(self._span_for(start))
        self.decode_programs.add(("chunk", final, attn_span))
        t0 = time.time()
        tok_dev = self._prefill_chunk_fn(
            upload(chunk, self.device), start, n_valid, req.slot,
            st.total if final else self.max_len, self.table_device(),
            final=final, span=attn_span, kernel=self._kernel)
        t_disp = time.time()              # dispatch returned
        chunk_key = self.compile_watch.last_key
        # Deliberate difference from the reference: only the final
        # chunk is fetched (its token is the request's next one); a
        # non-final chunk's record ends at its dispatch, so its
        # fetch_wall_ms is 0.
        tok = int(tok_dev) if final else None      # host sync
        end_s = time.time() if final else t_disp
        dt = end_s - t0
        req.n_chunks += 1
        PREFILL_CHUNKS.inc()
        if decode_active:
            DECODE_STALL_SECONDS.observe(dt)
        self._record_flight(
            "chunk", begin_s=t0, end_s=end_s,
            program={"span": attn_span, "final": final},
            slots=[req.slot], reqs=[req], toks=1 if final else 0,
            stall=decode_active, dispatch_s=t_disp, dev_keys=[chunk_key])
        st.pos += n_valid
        if not final:
            return True
        now = time.time()
        self.chunking.popleft()
        tracing.record_span(
            "engine.prefill", req.prefill_begin_s, now,
            parent=req.span_ctx,
            attrs={"rid": req.rid, "bucket": "chunked",
                   "cached_len": req.cached_len, "chunks": req.n_chunks})
        req.tokens.append(tok)
        if req.first_token_s is None:          # once per request
            req.first_token_s = now
            TTFT_SECONDS.observe(max(now - req.submit_s, 0.0))
        PREFILL_SECONDS.labels(bucket="chunked").observe(
            max(now - req.prefill_begin_s, 0.0))
        PREFILL_REQUESTS.labels(bucket="chunked").inc()
        self.slot_req[req.slot] = req
        self._store_prefix(st.ctx, req.slot, len(st.ctx),
                           salt=self._prefix_salt(req))
        if self._req_finished(req, tok):
            self._retire(req)
        self._update_gauges()
        return True

    # -- prefix cache ------------------------------------------------------

    def _store_prefix(self, ctx: List[int], slot: int, rows: int,
                      donor_live: bool = True, salt: bytes = b"") -> int:
        """Install ``ctx``'s chunk-aligned prefix (a prompt, or a
        resume's prompt + committed tokens), over the slot's first
        ``rows`` resident rows, into the prefix cache unless it is
        already resident. Returns the rows installed (0 on every skip:
        no index, a prefix shorter than one chunk, already covered, a
        dry pool). Only chunk-path sequences are stored, so a later hit
        replays the chunk program's own rows (or, from a preempted slot,
        the literal bytes decode committed).

        The slot's full blocks over the prefix are increfed and become
        the entry's payload. A trailing partial block is copied on share
        while the donor lives (it keeps writing into its own copy past
        the prefix); a dying donor (preemption) shares it by incref
        alone, since no writer remains. Contiguous: the slot's whole row
        copies into a pool row (:meth:`PrefixIndex.acquire_row`, LRU;
        live donors only, so a contiguous preemption resumes cold).
        ``salt``: the request's adapter namespace
        (:meth:`_prefix_salt`)."""
        idx = self._prefix_index
        if idx is None:
            return 0
        n = (rows // idx.block) * idx.block
        if n < idx.block:
            return 0
        covered = idx.lookup(ctx, salt)
        if covered is not None and covered[1] >= n:
            return 0
        if not self.paged:
            if not donor_live:
                return 0
            row, evicted = idx.acquire_row()
            if evicted:
                self._count_eviction()
            self._pool_store_fn(self.pool, self.cache, slot, row)
            idx.register(ctx, n, row, salt)
            return n
        n_full, partial = divmod(n, self.kv_block)
        blocks = self.block_table[slot, :n_full + (1 if partial else 0)
                                  ].tolist()
        if partial and donor_live:
            cow = self._alloc_blocks(1)
            if cow is None:                    # pool dry: skip storing
                return 0
            self._copy_block_fn(self.cache, blocks[n_full], cow[0])
            self._count_cow()
            blocks[n_full] = cow[0]
        for b in blocks[:n_full]:
            self.allocator.incref(b)
        if partial and not donor_live:
            self.allocator.incref(blocks[n_full])
        for payload in idx.insert_entry(ctx, n, tuple(blocks), salt):
            self._count_eviction()
            for b in payload:
                self.allocator.decref(b)
        return n

    def clear_prefix_cache(self) -> None:
        """Drop every resident prefix and release its block references
        (blocks still mapped into live slots stay until those retire).
        Benchmarks use this to measure a cold pass against a warm one on
        the same engine."""
        idx = self._prefix_index
        if idx is None:
            return
        if self.paged:          # contiguous: the pool rows just go stale
            for payload in idx.payloads():
                for b in payload:
                    self.allocator.decref(b)
        idx.clear()

    # -- cross-replica KV handoff (disaggregated serving) ------------------

    def handoff_eligible(self, prompt: List[int],
                         max_new_tokens: int) -> bool:
        """Whether a request prefilled here can hand its KV off to
        another replica: a prefix cache, a prompt with a cacheable
        prefix, more than one token to generate, and a resumed context
        (prompt + the one committed token) that the receiving tier
        admits through the chunk path (:meth:`_resumable`)."""
        return (self.paged and self._prefix_index is not None
                and self._prefix_index.eligible(prompt)
                and max_new_tokens > 1
                and self._resumable(len(prompt) + 1))

    def export_prefix_for(self, req: Request) -> Optional[Dict[str, Any]]:
        """Host copy of the retired request's stored prefix, for a
        decode-tier replica: ``cached_len``, ``kv_block``, ``n_blocks``,
        ``salt`` (the request's adapter namespace, :meth:`_prefix_salt`:
        the decode tier must key the import under it) and ``tensors``
        (numpy, [L, nb, ...] per pool,
        :func:`kvcache.export_blocks`). The entry's blocks stay resident
        here, ref-counted and LRU like any stored prefix. Float planes
        are widened to float32 on the device before the host copy (as
        the reference widens bfloat16 at encode: the wire bytes are the
        same, and numpy needs no bfloat16 type). None when no prefix of
        the request is resident (the caller serves it single-tier)."""
        idx = self._prefix_index
        if not self.paged or idx is None:
            return None         # contiguous: no handoff, as the reference
        salt = self._prefix_salt(req)
        hit = idx.lookup(self._ctx(req), salt)
        if hit is None:
            return None
        payload, cached = hit
        ids = torch.tensor(payload, dtype=torch.long, device=self.device)
        tensors = {}
        for name, v in self._export_blocks_fn(self.cache, ids).items():
            if v.is_floating_point():
                v = v.float()
            tensors[name] = v.cpu().numpy()
        return {"cached_len": cached, "kv_block": self.kv_block,
                "n_blocks": len(payload), "salt": salt, "tensors": tensors}

    def import_prefix(self, ctx: List[int], export: Dict[str, Any],
                      salt: bytes = b"") -> int:
        """Install another replica's exported prefix (the dict
        :meth:`export_prefix_for` returns, from this port or the
        reference) into fresh blocks of this pool and the prefix index
        under ``salt``, so the handed-off request resumes through an
        ordinary prefix hit. Returns the rows of ``ctx`` now resident:
        0 when nothing was imported (another block length, model or
        shape, an int8 export into a float pool or the reverse, a dry
        pool: the request then resumes cold, with the same tokens), or
        the rows already resident when this engine is at least as warm.
        """
        idx = self._prefix_index
        if not self.paged or idx is None:
            return 0            # contiguous: no handoff, as the reference
        if export.get("kv_block") != self.kv_block:
            return 0            # geometry mismatch: resume cold
        cached = int(export["cached_len"])
        nb = int(export["n_blocks"])
        tensors = export["tensors"]
        cache0 = sharding.shards_of(self.cache)[0]
        if nb != -(-cached // self.kv_block) or nb < 1 or set(tensors) != {
                n for n in ("k", "v", "k_scale", "v_scale")
                if n in cache0}:
            return 0            # int8 against float, or a torn export
        for name, have in tensors.items():
            want = cache0[name]
            shape = self._wire_shape(name)      # every kv head
            # The wire carries float planes as float32 (exact; the
            # scatter casts back); int8 against float is a real
            # quantization mismatch.
            hdt = str(have.dtype)
            ok_dtype = (hdt == str(want.dtype).removeprefix("torch.")
                        or (hdt == "float32" and want.is_floating_point()))
            if tuple(have.shape) != (shape[0], nb) + shape[2:] \
                    or not ok_dtype:
                return 0        # model/dtype mismatch: resume cold
        covered = idx.lookup(ctx, salt)
        if covered is not None and covered[1] >= cached:
            return covered[1]   # already at least as warm
        blocks = self._alloc_blocks(nb)
        if blocks is None:
            return 0            # pool dry: resume cold
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        self._import_blocks_fn(self.cache, ids, {
            name: torch.from_numpy(np.require(arr, requirements="CW")).to(
                self.device)
            for name, arr in tensors.items()})
        for payload in idx.insert_entry(ctx, cached, tuple(blocks), salt):
            self._count_eviction()
            for b in payload:
                self.allocator.decref(b)
        return cached

    # -- decoding ----------------------------------------------------------

    def _req_finished(self, req: Request, tok: int) -> bool:
        if req.eos_id is not None and tok == req.eos_id:
            return True
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return self._ctx_len(req) >= self.max_len

    def _retire(self, req: Request) -> None:
        req.done = True
        self.finished.append(req)
        REQUESTS_FINISHED.inc()
        self._end_stall(req)
        now = time.time()
        decoded = req.first_token_s is not None and len(req.tokens) > 1
        if req.span_ctx is not None:
            if decoded:
                # ONE decode span per request (first token to
                # retirement): a span per slot per burst would flood the
                # ring at high occupancy.
                tracing.record_span(
                    "engine.decode", req.first_token_s, now,
                    parent=req.span_ctx,
                    attrs={"rid": req.rid, "tokens": len(req.tokens) - 1})
            tracing.record_span(
                "engine.request", req.submit_s, now,
                ctx=req.span_ctx, parent_id=req.parent_id,
                attrs={"rid": req.rid, "prompt_len": len(req.prompt),
                       "n_tokens": len(req.tokens)})
        if decoded:
            TPOT_SECONDS.observe(
                max(now - req.first_token_s, 0.0) / (len(req.tokens) - 1))
        if self.forensics:
            # ONE retirement record anchors the request's ledger, then
            # the tail detector decides whether to pin its evidence.
            self._record_event(
                "retire", [req.slot] if req.slot is not None else [],
                [req.rid], ts_s=now,
                traces=([req.span_ctx.trace_id]
                        if req.span_ctx is not None else []),
                submit_s=req.submit_s, first_token_s=req.first_token_s,
                end_s=now, prompt_len=len(req.prompt),
                n_toks=len(req.tokens), cached_len=req.cached_len,
                resumed_len=req.resumed_len, n_chunks=req.n_chunks,
                spec_drafted=req.spec_drafted,
                spec_accepted=req.spec_accepted,
                preemptions=req.preemptions,
                stalls={k: round(v, 4) for k, v in req.stall_ms.items()},
                tenants={req.tenant: 1}, adapter=req.adapter)
            self._observe_tail(req, now)
        if req.slot is not None:
            self.slot_req.pop(req.slot, None)
            self.free_slots.append(req.slot)
            self._free_slot_blocks(req.slot)
            self._set_slot_adapter(req.slot, 0)
            if self.draft_engine is not None:
                # The mirrored draft slot frees its blocks with the slot
                # (the slot's next occupant re-ingests from zero).
                self.draft_engine.release(req.slot)
            req.slot = None
        self._release_adapter(req)
        SLOTS_ACTIVE.set(len(self.slot_req))
        if self.paged:
            KV_BLOCKS_USED.set(self.allocator.used)

    def _observe_tail(self, req: Request, now: float) -> None:
        """Streaming tail detection at retirement: fold the request's
        TTFT/TPOT into the P2 estimators and, when it crosses the
        configured quantile, pin its full evidence (retirement record,
        every flight record it rode, its ledger) into the exemplar
        store. The ring scan runs only on a crossing."""
        if metrics.suppressed():      # warmup must not skew the tail
            return
        hits = []
        if req.first_token_s is not None:
            ttft_ms = max(req.first_token_s - req.submit_s, 0.0) * 1e3
            crossed, thr = self.tail.observe("ttft", ttft_ms)
            if crossed:
                hits.append(("ttft", ttft_ms, thr))
            if len(req.tokens) > 1:
                tpot_ms = (max(now - req.first_token_s, 0.0) * 1e3
                           / (len(req.tokens) - 1))
                crossed, thr = self.tail.observe("tpot", tpot_ms)
                if crossed:
                    hits.append(("tpot", tpot_ms, thr))
        if not hits:
            return
        fl = self.flight
        recs: List[Dict[str, Any]] = []
        retire = None
        if fl is not None and fl.enabled:
            for r in fl.tail():
                if req.rid in (r.get("rids") or ()):
                    recs.append(r)
                    if r.get("burst") == "retire":
                        retire = r
        ledger = (forensics_lib.build_ledger(retire, recs)
                  if retire is not None else None)
        for metric, value, thr in hits:
            forensics_lib.TAIL_EXEMPLARS_PINNED.labels(metric=metric).inc()
            self.exemplars.pin({
                "rid": req.rid, "metric": metric,
                "value_ms": round(value, 4),
                "threshold_ms": (round(thr, 4) if thr is not None
                                 else None),
                "ts_s": now,
                "trace_id": (req.span_ctx.trace_id
                             if req.span_ctx is not None else None),
                "tenant": req.tenant, "adapter": req.adapter,
                "retire": retire, "records": recs, "ledger": ledger})

    def dispatch_decode_burst(self, max_burst: int = 8
                              ) -> Optional[BurstHandle]:
        """Enqueue one decode burst WITHOUT fetching its tokens; pass the
        handle to :meth:`complete_decode_burst` later. A streaming
        server dispatches burst k+1 before fetching burst k, so the card
        decodes while the host streams. The burst length is capped so
        no active slot's cache can overflow (counting tokens in flight)
        and rounded down to a power of two. Returns None when there is
        nothing to decode. Runs behind the ``decode`` dispatch
        boundary."""
        if not self.slot_req:
            return None
        with _dispatch_boundary("decode"):
            return self._dispatch_decode_burst_impl(max_burst)

    def _dispatch_decode_burst_impl(self, max_burst: int
                                    ) -> Optional[BurstHandle]:
        k = max_burst
        need = 0
        for req in self.slot_req.values():
            k = min(k, self.max_len - self._slot_rows(req))
            need = max(need, req.max_new_tokens - len(req.tokens)
                       - self._inflight_tokens)
        if k < 1 or need < 1:
            return None
        k = 1 << (k.bit_length() - 1)
        # Lazy mode grows each slot's blocks here; a slot the pool
        # cannot grow sits the round out.
        groups = self._span_groups(k)
        if not groups:
            return None            # lazy: pool dry, retry next round
        ev = timeline.Event("skytpu_decode_step_seconds",
                            histogram=DECODE_STEP_SECONDS)
        ev.begin()
        self._note_adapter_mix(s for _, slots in groups for s in slots)
        parts: List[Tuple[torch.Tensor, List[int]]] = []
        part_spans: List[Optional[int]] = []
        part_keys: List[Optional[str]] = []
        for span, slots in groups:
            DECODE_ATTN_ROWS.observe(span)
            active = np.zeros((self.n_slots,), bool)
            active[slots] = True
            sarg = self._span_arg(span)
            self.decode_programs.add(("burst", k, sarg))
            toks = self._decode_burst_fn(
                upload(active, self.device), self.table_device(), k=k,
                span=sarg, kernel=self._kernel)
            parts.append((toks, slots))
            part_spans.append(sarg)
            part_keys.append(self.compile_watch.last_key)
        self._inflight_tokens += k
        return BurstHandle(parts=parts, k=k, slot_req=dict(self.slot_req),
                           span=ev, spans=part_spans, keys=part_keys,
                           dispatch_s=time.time())

    def complete_decode_burst(self, handle: BurstHandle
                              ) -> Dict[int, List[int]]:
        """Fetch a dispatched burst's tokens (host sync) and append or
        retire per request, using the slot->request snapshot taken at
        dispatch. Tokens past a request's EOS or budget are discarded.
        Slots a lazy dry pool kept out of the burst have no part and
        emit nothing this round. Returns {rid: [tokens...]}. Runs behind
        the ``decode`` dispatch boundary: a failure here commits none of
        the burst's tokens."""
        with _dispatch_boundary("decode"):
            return self._complete_decode_burst_impl(handle)

    def _complete_decode_burst_impl(self, handle: BurstHandle
                                    ) -> Dict[int, List[int]]:
        fetched = [(toks.cpu().numpy(), slots)
                   for toks, slots in handle.parts]
        if handle.span is not None:
            handle.span.end()
        end_s = time.time()
        begin_s = (handle.span.begin_s if handle.span is not None
                   else end_s)
        self._inflight_tokens -= handle.k
        out: Dict[int, List[int]] = {}
        for part_i, (toks, slots) in enumerate(fetched):
            part_emitted = 0
            part_reqs: List[Request] = []
            for slot in slots:
                req = handle.slot_req.get(slot)
                if req is None or req.done:
                    continue
                emitted = []
                for i in range(handle.k):
                    tok = int(toks[i, slot])
                    emitted.append(tok)
                    req.tokens.append(tok)
                    if self._req_finished(req, tok):
                        self._retire(req)
                        break
                out[req.rid] = emitted
                part_emitted += len(emitted)
                part_reqs.append(req)
            self._record_flight(
                "decode", begin_s=begin_s, end_s=end_s,
                program={"k": handle.k,
                         "span": (handle.spans[part_i]
                                  if part_i < len(handle.spans) else None)},
                slots=slots, reqs=part_reqs, toks=part_emitted,
                dispatch_s=handle.dispatch_s,
                dev_keys=([handle.keys[part_i]]
                          if part_i < len(handle.keys) else None))
        n = sum(len(v) for v in out.values())
        if n:
            DECODE_TOKENS.inc(n)
        return out

    def decode_burst(self, max_burst: int = 8) -> Dict[int, List[int]]:
        """Decode up to ``max_burst`` tokens per active slot, no
        admission. With speculation on, a verify round replaces the
        plain burst whenever some active slot drafted."""
        if self.spec_k:
            out = self.spec_decode_burst()
            if out is not None:
                return out
        handle = self.dispatch_decode_burst(max_burst)
        if handle is None:
            return {}
        return self.complete_decode_burst(handle)

    # -- speculative decoding ----------------------------------------------

    def _spec_mode(self, req: Request) -> str:
        """Resolve (and advance) this request's drafter rung. Requests
        start at "model" when the engine has a draft engine, else at
        "ngram" (the factory seam; test drafters ride it too). An
        acceptance collapse in the current rung (>= spec_min_drafted
        drafted below spec_min_rate accepted since the last demotion)
        demotes one rung: model -> ngram (a fresh window, a fresh factory
        drafter, the draft slot released) -> off."""
        if req.spec_off:
            return "off"
        if req.spec_mode is None:
            req.spec_mode = ("model" if self.draft_engine is not None
                             else "ngram")
        if req.spec_mode == "model" and self.draft_engine is None:
            # The drafter was detached mid-flight (the bench toggles it
            # between passes): the factory rung, with a fresh window.
            req.spec_mode = "ngram"
            req.spec_mode_drafted = 0
            req.spec_mode_accepted = 0
        if (req.spec_mode_drafted >= self.spec_min_drafted
                and req.spec_mode_accepted
                < self.spec_min_rate * req.spec_mode_drafted):
            if req.spec_mode == "model":
                req.spec_mode = "ngram"
                req.spec_mode_drafted = 0
                req.spec_mode_accepted = 0
                req.drafter = None       # the factory rebuilds it
                if self.draft_engine is not None \
                        and req.slot is not None:
                    self.draft_engine.release(req.slot)
            else:
                req.spec_mode = "off"
                req.spec_off = True
        return req.spec_mode

    def _draft_for(self, req: Request) -> List[int]:
        """This request's draft through the per-request factory seam
        (n-gram by default; the rung below the model drafter).
        Host-only: builds the drafter lazily and syncs it with tokens
        committed through any path."""
        if req.drafter is None:
            req.drafter = self._spec_drafter_factory(req)
            if req.drafter is None:          # factory opted this one out
                req.spec_off = True
                req.spec_mode = "off"
                return []
        req.drafter.catch_up(req.prompt, req.tokens)
        return req.drafter.draft(self.spec_k)

    def spec_decode_burst(self) -> Optional[Dict[int, List[int]]]:
        """One draft-and-verify round for every active slot: the drafters
        propose up to K tokens per slot (model-rung slots in one batched
        draft burst), one verify call per span group scores the K+1
        window positions, and each slot commits its matched run plus the
        correction token (fetched at once: the next round's window needs
        them). With a draft engine and ``spec_pipeline``, the next
        round's draft burst (K+1 steps: the drafter's guess at the
        correction token, then the next K drafts) is enqueued after the
        verify calls and before the fetch, so the card runs it behind
        the verify while the host waits; the next round's
        ``draft_batch`` checks it against what was committed. Returns
        {rid: [tokens...]}, or None when no active slot drafted (all
        missed, collapsed or without K+1 rows of headroom): a plain
        burst then does the same work cheaper. Runs behind the ``verify``
        dispatch boundary."""
        if not self.slot_req or self.spec_k <= 0:
            return None
        with _dispatch_boundary("verify"):
            return self._spec_decode_burst_impl()

    def _spec_decode_burst_impl(self) -> Optional[Dict[int, List[int]]]:
        K = self.spec_k
        draft = np.zeros((self.n_slots, K), np.int64)
        n_draft = np.zeros((self.n_slots,), np.int64)
        dlen: Dict[int, int] = {}
        model_reqs: Dict[int, Request] = {}
        for slot, req in self.slot_req.items():
            # A slot within K+1 rows of max_len drafts nothing: its one
            # correction row stays in bounds and its spare window rows
            # land in the trash block, while other slots keep drafting.
            if len(req.prompt) + len(req.tokens) + K + 1 > self.max_len:
                continue
            mode = self._spec_mode(req)
            if mode == "off":
                continue
            if mode == "model":
                # Drafted below, in one draft burst for every such slot.
                model_reqs[slot] = req
                continue
            d = self._draft_for(req)
            if d:
                n_draft[slot] = len(d)
                draft[slot, :len(d)] = d
                dlen[slot] = len(d)
        if model_reqs:
            batch = self.draft_engine.draft_batch(
                {s: self._ctx(r) for s, r in model_reqs.items()}, K)
            for slot, d in batch.items():
                if d:
                    n_draft[slot] = len(d)
                    draft[slot, :len(d)] = d
                    dlen[slot] = len(d)
        if not dlen:
            return None
        groups = self._span_groups(K + 1)
        if not sum(dlen.get(s, 0) for _, slots in groups for s in slots):
            # Every drafting slot was kept out (lazy dry pool): a
            # K+1-wide verify for the rest would be strictly worse than
            # the plain burst the caller falls back to.
            return None
        step_ev = timeline.Event("skytpu_decode_step_seconds",
                                 histogram=DECODE_STEP_SECONDS)
        step_ev.begin()
        t0 = step_ev.begin_s
        self._note_adapter_mix(s for _, slots in groups for s in slots)
        draft_dev = upload(draft, self.device)
        n_draft_dev = upload(n_draft, self.device)
        parts = []
        part_spans: List[Optional[int]] = []
        part_keys: List[Optional[str]] = []
        for span, slots in groups:
            DECODE_ATTN_ROWS.observe(span)
            active = np.zeros((self.n_slots,), bool)
            active[slots] = True
            sarg = self._span_arg(span)
            self.decode_programs.add(("verify", K, sarg))
            toks, n_commit = self._verify_fn(
                draft_dev, n_draft_dev, upload(active, self.device),
                self.table_device(), k=K, span=sarg, kernel=self._kernel)
            self.verify_calls += 1
            parts.append((slots, toks, n_commit))
            part_spans.append(sarg)
            part_keys.append(self.compile_watch.last_key)
        dispatch_done_s = time.time()       # every verify call enqueued
        # The pipelined predraft, enqueued behind the verify calls; its
        # "draft" record spans the rollout's dispatch.
        overlap_s = 0.0
        pre_slots = [s for s in dlen if s in model_reqs]
        if self.spec_pipeline and pre_slots:
            t_d0 = time.time()
            if self.draft_engine.rollout(pre_slots, K + 1):
                t_d1 = time.time()
                overlap_s = t_d1 - t_d0
                SPEC_OVERLAP_WALL.inc(overlap_s)
                self._record_flight(
                    "draft", begin_s=t_d0, end_s=t_d1,
                    program={"k": K + 1, "span": None},
                    slots=pre_slots,
                    reqs=[model_reqs[s] for s in pre_slots], toks=0,
                    drafter="model",
                    dev_keys=[self.draft_engine.compile_watch.last_key],
                    calibrator=self.draft_engine.devtime)
        out: Dict[int, List[int]] = {}
        drafted = accepted = 0
        model_drafted = ngram_drafted = 0
        fetched = [(slots, toks_dev.cpu().numpy(), commit_dev.cpu().numpy())
                   for slots, toks_dev, commit_dev in parts]   # host sync
        step_ev.end()
        end_s = time.time()
        SPEC_VERIFY_WALL.inc(max(end_s - t0, 0.0))
        for part_i, (slots, toks, n_commit) in enumerate(fetched):
            grp_emitted = grp_drafted = grp_accepted = 0
            grp_reqs: List[Request] = []
            grp_kinds = set()
            for slot in slots:
                req = self.slot_req.get(slot)
                if req is None or req.done:
                    continue
                nd = dlen.get(slot, 0)
                nc = int(n_commit[slot])
                emitted: List[int] = []
                for i in range(nc):
                    tok = int(toks[slot, i])
                    emitted.append(tok)
                    req.tokens.append(tok)
                    if self._req_finished(req, tok):
                        self._retire(req)
                        break
                # Accepted = matched draft tokens actually emitted: the
                # first nc - 1 outputs are the matched run, the nc-th the
                # correction; an EOS or budget retirement drops the rest.
                acc = min(len(emitted), nc - 1)
                req.spec_drafted += nd
                req.spec_accepted += acc
                req.spec_mode_drafted += nd
                req.spec_mode_accepted += acc
                if nd:
                    if slot in model_reqs:
                        model_drafted += nd
                        grp_kinds.add("model")
                    else:
                        ngram_drafted += nd
                        grp_kinds.add("ngram")
                drafted += nd
                accepted += acc
                out[req.rid] = emitted
                grp_emitted += len(emitted)
                grp_drafted += nd
                grp_accepted += acc
                grp_reqs.append(req)
            self._record_flight(
                "verify", begin_s=t0, end_s=end_s,
                program={"k": K, "span": part_spans[part_i]},
                slots=slots, reqs=grp_reqs, toks=grp_emitted,
                drafted=grp_drafted, accepted=grp_accepted,
                drafter=("mixed" if len(grp_kinds) > 1
                         else next(iter(grp_kinds), None)),
                overlap_ms=round(overlap_s * 1e3, 3),
                dispatch_s=dispatch_done_s, dev_keys=[part_keys[part_i]])
        if model_drafted:
            SPEC_DRAFT_TOKENS.labels(drafter="model").inc(model_drafted)
        if ngram_drafted:
            SPEC_DRAFT_TOKENS.labels(drafter="ngram").inc(ngram_drafted)
        self._spec_drafted_total += drafted
        self._spec_accepted_total += accepted
        SPEC_DRAFTED.inc(drafted)
        if accepted:
            SPEC_ACCEPTED.inc(accepted)
        if drafted > accepted:
            SPEC_ROLLBACKS.inc(drafted - accepted)
        if self._spec_drafted_total:
            SPEC_ACCEPT_RATE.set(self._spec_accepted_total
                                 / self._spec_drafted_total)
        n = sum(len(v) for v in out.values())
        if n:
            DECODE_TOKENS.inc(n)
        return out

    def step(self) -> Dict[int, int]:
        """Admit waiting requests (draining any chunked prefills to
        completion: single-step callers want classic semantics), then
        decode one token per active slot. Returns {rid: token} emitted
        this step."""
        self.admit()
        while self.chunking:
            self.prefill_chunk_step()
        return self.step_decode_once()

    def step_decode_once(self) -> Dict[int, int]:
        """One single-token decode for every active slot (no admission),
        at ONE span: the rung covering the longest active slot (the
        classic-semantics path; the burst path is where regrouping
        pays). Runs behind the ``decode`` dispatch boundary. Raises
        :class:`KvPoolWedgedError` when lazy growth cannot back any
        active slot (no outstanding burst could free blocks)."""
        if not self.slot_req:
            return {}
        with _dispatch_boundary("decode"):
            return self._step_decode_once_impl()

    def _step_decode_once_impl(self) -> Dict[int, int]:
        active = np.zeros((self.n_slots,), bool)
        rows_max = 0
        for slot, req in self.slot_req.items():
            if not self._ensure_headroom(slot, req,
                                         self._slot_rows(req) + 1):
                continue            # lazy: pool dry, sits this one out
            active[slot] = True
            rows_max = max(rows_max, self._slot_rows(req))
        if not rows_max:
            raise KvPoolWedgedError(
                "KV block pool exhausted: lazy growth cannot back any "
                "active slot — size SKYTPU_KV_BLOCKS for the live "
                "working set or disable SKYTPU_KV_LAZY")
        sarg = self._span_arg(self._span_for(rows_max))
        self.decode_programs.add(("decode1", 1, sarg))
        ev = timeline.Event("skytpu_decode_step_seconds",
                            histogram=DECODE_STEP_SECONDS)
        ev.begin()
        self._note_adapter_mix(s for s in self.slot_req if active[s])
        toks_dev = self._decode_fn(upload(active, self.device),
                                   self.table_device(), span=sarg)
        t_disp = time.time()
        step_key = self.compile_watch.last_key
        toks = toks_dev.cpu().numpy()             # host sync
        ev.end()
        out: Dict[int, int] = {}
        step_slots: List[int] = []
        step_reqs: List[Request] = []
        for slot, req in list(self.slot_req.items()):
            if not active[slot]:
                continue
            tok = int(toks[slot])
            req.tokens.append(tok)
            out[req.rid] = tok
            step_slots.append(slot)
            step_reqs.append(req)
            if self._req_finished(req, tok):
                self._retire(req)
        DECODE_TOKENS.inc(len(out))
        self._record_flight(
            "decode1", begin_s=ev.begin_s, end_s=time.time(),
            program={"k": 1, "span": sarg}, slots=step_slots,
            reqs=step_reqs, toks=len(out), dispatch_s=t_disp,
            dev_keys=[step_key])
        return out

    def step_burst(self, max_burst: int = 8,
                   on_wave=None) -> Dict[int, List[int]]:
        """Admit, run ONE prefill chunk if any are queued (chunk ->
        decode-burst alternation), then decode up to ``max_burst`` tokens
        per slot."""
        self.admit(on_wave)
        if self.chunking:
            self.prefill_chunk_step()
        return self.decode_burst(max_burst)

    def run_to_completion(self, max_burst: int = 8) -> List[Request]:
        """Drain all waiting, chunking and active requests; returns the
        finished list. Lazy mode can genuinely wedge (every active slot
        needs blocks the pool cannot grow and nothing can retire):
        eager admission makes that impossible by construction; here it
        is detected and raised instead of spinning forever."""
        stalled = 0
        while self.waiting or self.chunking or self.slot_req:
            had_chunks = bool(self.chunking)
            before = len(self.finished)
            out = self.step_burst(max_burst)
            progress = (bool(out) or had_chunks
                        or len(self.finished) > before)
            stalled = 0 if progress else stalled + 1
            if self.kv_lazy and self.slot_req and stalled > 2:
                raise KvPoolWedgedError(
                    "KV block pool exhausted: lazy growth cannot back "
                    "any active slot and nothing can retire — size "
                    "SKYTPU_KV_BLOCKS for the live working set or "
                    "disable SKYTPU_KV_LAZY")
        return self.finished

    def reset(self) -> None:
        """Drop every queued and in-flight request and zero the slot
        state (after a failure the server must not re-drive poisoned
        slots)."""
        self.waiting.clear()
        self.chunking.clear()
        self.finished.clear()
        self.slot_req.clear()
        self.free_slots = list(range(self.n_slots))
        self._inflight_tokens = 0
        # The prefix entries' block refs die with the allocator's reset:
        # a failure mid-claim may have left the counts inconsistent, so
        # the index is cleared without per-block decrefs.
        if self._prefix_index is not None:
            self._prefix_index.clear()
        if self.paged:
            self.allocator.reset()
            self.block_table[:] = self.n_kv_blocks
            self._table_dirty = True
            self._slot_kv_charge.clear()
            for t in list(self._tenant_kv):
                self._set_tenant_kv(t, 0)
        if self.adapters is not None:
            # A failure mid-load may have left pins inconsistent: drop
            # all residency (the pool tensors stay; nothing maps to them
            # until re-acquired).
            self.adapters.reset()
            self.adapter_ids[:] = 0
            self._aid_dirty = True
        if self.draft_engine is not None:
            # Drafter state mirrors the slots just wiped.
            self.draft_engine.reset()
        for c in sharding.shards_of(self.cache):
            c["length"].zero_()
        self._update_gauges()

    def recover(self, exc: Optional[BaseException] = None) -> int:
        """Crash recovery: a full :meth:`reset` (host and device state
        may disagree after a failed dispatch; nothing narrower is safe),
        then every queued or in-flight request re-queues through the
        preemption resume path. A crash is an involuntary preemption of
        every resident at once: each victim re-admits with its prompt
        plus its committed tokens (:meth:`_ctx`), re-prefills that
        context cold, and its greedy continuation equals an
        uninterrupted run's. Finished requests stay finished; the server
        keeps streaming the same Request objects. Returns the number of
        requests re-queued."""
        # Snapshot before the wipe, each class in arrival order:
        # residents, chunkers (disjoint from residents until their final
        # chunk) and the queue.
        residents = sorted(self.slot_req.values(), key=lambda r: r.rid)
        chunkers = [st.req for st in self.chunking]
        chunker_rids = {r.rid for r in chunkers}
        queued = list(self.waiting)
        finished = list(self.finished)
        self.reset()
        self.finished.extend(finished)
        seam = getattr(exc, "seam", None) or "unknown"
        now = time.time()
        victims: List[Request] = []
        seen = set()
        for req in residents + chunkers + queued:
            if req.done or req.rid in seen:
                continue
            seen.add(req.rid)
            victims.append(req)
        for req in victims:
            in_flight = req.slot is not None or req.rid in chunker_rids
            # reset() wiped the tables and pins wholesale: scrub the
            # per-request mirrors without the release paths (a decref or
            # an unpin now would double-free against the wiped state).
            req.slot = None
            req.adapter_pinned = False
            req.adapter_slot = 0
            if in_flight:
                req.recoveries += 1
                self._mark_stall(req, "recover")
            self._requeue(req)
        self.waiting.reverse()          # _requeue prepends: arrival order
        ENGINE_RECOVERIES.labels(seam=seam).inc()
        self._record_event("recover", [], [r.rid for r in victims],
                           ts_s=now, program={"seam": seam},
                           n_victims=len(victims))
        self._update_gauges()
        return len(victims)

    def generate(self, prompts: List[List[int]],
                 max_new_tokens: int = 128) -> List[List[int]]:
        ids = [self.add_request(p, max_new_tokens) for p in prompts]
        self.run_to_completion()
        by_rid = {r.rid: r for r in self.finished}
        return [by_rid[i].tokens for i in ids]


def _roofline(cfg: llama.LlamaConfig, weight_bytes: int,
              kv_token_bytes: int, max_len: int,
              chunk_tokens: Optional[int]) -> attribution_lib.Roofline:
    return attribution_lib.Roofline(
        param_count=cfg.num_params(), weight_bytes=weight_bytes,
        kv_token_bytes=kv_token_bytes, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        head_dim=cfg.head_dim, max_len=max_len, chunk_tokens=chunk_tokens)


def _tree_device(tree) -> torch.device:
    """The device of a tree's first tensor."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
