"""Continuous-batching inference engine over the paged KV cache.

Counterpart of the core of ``skypilot_tpu/infer/engine.py`` for one
configuration: paged KV (block table, ref-counted block allocator), wave
admission grouped by prompt bucket, chunked prefill of long prompts, and
staged decode bursts whose slots regroup by span rung. Greedy decoding
is the contract; temperature and top-k sample from the engine's own
``torch.Generator``.

A fixed pool of decode slots advances a burst of tokens per device call
for every active request, while new requests prefill into free slots
between bursts. Every request reserves its worst-case KV blocks (prompt
plus token budget, capped by ``max_len``) at admission, so decode never
runs out of backing mid-flight; the pool, not a fault path, limits
admission.

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

Left for later slices of the port: preemption, the draft model, LoRA
adapters, QoS, the flight recorder, metrics, tracing and crash
recovery. The JAX engine padded admission waves to fixed row counts
to avoid recompiles; PyTorch runs eagerly, so the port dispatches each
wave at its own size and keeps no spare slot for padding rows.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.infer import kvcache, sampling
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import paged_attention as pa


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
    n_chunks: int = 0                 # prefill chunks run for this request
    cached_len: int = 0               # prompt rows reused from the cache
    # A resume (admitted with committed tokens, as a KV handoff is):
    # the context rows its claim reused from the prefix cache (the
    # imported blocks); ``cached_len`` stays the first admission's.
    resumed_len: int = 0
    # Speculative decoding: lifetime drafted/accepted tokens (the
    # response trailer) and the drafter state. ``spec_mode`` is the
    # drafter rung ("ngram", then "off" once acceptance collapses);
    # ``spec_mode_drafted``/``_accepted`` count since the last demotion.
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_off: bool = False
    drafter: Optional[Any] = None
    spec_mode: Optional[str] = None
    spec_mode_drafted: int = 0
    spec_mode_accepted: int = 0


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

    An entry's *payload* is a TUPLE of ref-counted block ids
    (``insert_entry`` — the caller owns the ref-count bookkeeping and
    decrefs whatever ``evict_lru``/``clear``/``insert_entry`` report
    as evicted). ``rows`` caps resident entries. (The JAX engine's
    contiguous layout also stores pool-row payloads through
    ``acquire_row``; the port serves the paged layout only.)
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
    the n-gram drafter over the prompt.
    """

    def __init__(self, params: llama.Params, cfg: llama.LlamaConfig,
                 n_slots: int = 8, max_len: int = 1024,
                 prompt_buckets: Tuple[int, ...] = (128, 512, 1024),
                 sampling_params: sampling.SamplingParams = sampling.SamplingParams(),
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_wave: Optional[int] = None, kv_block: int = 256,
                 kv_blocks: Optional[int] = None, span_buckets=None,
                 prefill_chunk: Optional[int] = 512,
                 prefix_pool: int = 0, spec_k: int = 0,
                 spec_drafter: Optional[Callable] = None,
                 kv_int8: bool = False, weights_int8: bool = False,
                 qweights: Optional[kvcache.QWeights] = None,
                 device: DeviceLike = None,
                 plain_attention: bool = False):
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        if qweights is not None:
            qweights = _to_device(qweights, self.device)
        elif weights_int8:
            qweights = {"blocks": kvcache.quantize_block_weights(params),
                        "head": kvcache.quantize_head(params, cfg)}
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
        self._spec_drafter_factory = (
            spec_drafter if spec_drafter is not None
            else (lambda req: NGramDrafter(req.prompt)))
        # Acceptance-collapse ladder: a request that has drafted at
        # least spec_min_drafted tokens below spec_min_rate acceptance
        # stops drafting.
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
        if kv_block <= 0:
            raise ValueError("the port serves the paged KV layout only: "
                             "kv_block must be > 0")
        b = kv_block_len(max_len, kv_block, self.device.type == "cuda")
        if kv_int8 and self.device.type == "cuda" and not (
                pa.tma_block_len(b)):
            raise ValueError(
                f"an int8 KV cache on the card needs a max_len that is a "
                f"multiple of 8 (got {max_len}): K1 reads int8 pools in "
                f"chunks only in blocks of 8, 16, 32 or a multiple of 64")
        self.kv_block = b
        nb = max_len // b
        self.n_kv_blocks = (kv_blocks if kv_blocks and kv_blocks > 0
                            else n_slots * nb)
        if self.n_kv_blocks < nb:
            raise ValueError(
                f"kv_blocks={self.n_kv_blocks} cannot hold one max_len "
                f"request ({nb} blocks of {b})")
        self.blocks_per_slot = nb
        self.allocator = kvcache.BlockAllocator(self.n_kv_blocks)
        # Per-slot block table, one extra column pinned to the sentinel
        # (== n_kv_blocks, the cache's trash block). Host numpy is
        # authoritative; a cached device copy rides into every program.
        self.block_table = np.full((n_slots, nb + 1), self.n_kv_blocks,
                                   np.int32)
        self._table_dev: Optional[torch.Tensor] = None
        self._table_dirty = True
        # Span-bucketed decode attention: each burst reads only the
        # first ``span`` logical rows of the rung covering its slots.
        self.span_ladder = _span_ladder(span_buckets, max_len)
        self.cache = kvcache.init_paged_cache(
            cfg, n_slots, self.n_kv_blocks, self.kv_block, self.device,
            kv_int8=kv_int8)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.free_slots: List[int] = list(range(n_slots))
        self.slot_req: Dict[int, Request] = {}
        self.waiting: Deque[Request] = collections.deque()
        self.chunking: Deque[_ChunkState] = collections.deque()
        self.finished: List[Request] = []
        self._next_rid = 0
        # Tokens dispatched to the device but not yet committed
        # host-side (one outstanding burst at a time; caps the next).
        self._inflight_tokens = 0

    # -- requests ----------------------------------------------------------

    def add_request(self, prompt: List[int],
                    max_new_tokens: int = 128,
                    committed: Optional[List[int]] = None) -> int:
        """Queue a request; returns its id. ``committed``: tokens another
        replica already committed (a KV handoff's decode tier): they are
        pre-seeded, so the request admits through the resume context
        (prompt + committed) and ``max_new_tokens`` still counts them."""
        _bucket(len(prompt), self.buckets)   # validate length up front
        req = Request(rid=self._next_rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      submit_s=time.time(), eos_id=self.eos_id)
        if committed:
            req.tokens = [int(t) for t in committed]
        self._next_rid += 1
        self.waiting.append(req)
        return req.rid

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a blocking copy."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def table_device(self) -> torch.Tensor:
        """The block table as a device tensor, re-uploaded only after a
        claim or retirement changed it."""
        if self._table_dirty or self._table_dev is None:
            self._table_dev = self._upload(self.block_table.copy())
            self._table_dirty = False
        return self._table_dev

    def blocks_used(self) -> int:
        return self.allocator.used

    # -- KV blocks ---------------------------------------------------------

    def _need_blocks(self, req: Request) -> int:
        """Blocks reserved at admission: the worst case, prompt plus the
        full token budget capped by max_len."""
        need = min(len(req.prompt) + req.max_new_tokens, self.max_len)
        return -(-need // self.kv_block)

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """n fresh blocks, evicting LRU prefix-cache entries on a dry
        pool (their blocks free unless still shared with live slots).
        None when the pool stays too dry: the caller leaves the request
        queued and admission retries after retirements."""
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
            self.prefix_evictions += 1
            for b in victim:
                alloc.decref(b)
        if alloc.available < n:
            return None
        return [alloc.alloc() for _ in range(n)]

    def _wave_claim(self, req: Request) -> Optional[int]:
        """Claim a slot and its KV blocks; None when the pool is too
        dry (the caller re-queues and stalls admission)."""
        blocks = self._alloc_blocks(self._need_blocks(req))
        if blocks is None:
            return None
        slot = self.free_slots.pop(0)
        row = self.block_table[slot]
        row[:] = self.n_kv_blocks
        row[:len(blocks)] = blocks
        self._table_dirty = True
        return slot

    def _free_slot_blocks(self, slot: int) -> None:
        """Release a slot's block references and clear its table row to
        the sentinel: later bursts' writes for the dead slot land in the
        trash block. A block a prefix entry still holds survives."""
        row = self.block_table[slot]
        for b in row[row < self.n_kv_blocks].tolist():
            self.allocator.decref(b)
        row[:] = self.n_kv_blocks
        self._table_dirty = True

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

    def _span_groups(self) -> List[Tuple[int, List[int]]]:
        """Active slots grouped by the span rung covering their rows,
        so one long conversation does not drag its short neighbours to
        its rung. Each group dispatches its own burst; a group's writes
        for other groups' slots land past their committed lengths and
        are overwritten before any read. Ascending spans."""
        groups: Dict[int, List[int]] = {}
        for slot, req in self.slot_req.items():
            groups.setdefault(self._span_for(self._slot_rows(req)),
                              []).append(slot)
        return sorted(groups.items())

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
        queue's head."""
        stalled = False
        while self.waiting and self.free_slots and not stalled:
            dispatched = []
            while self.waiting and self.free_slots and not stalled:
                if self._use_chunked(self.waiting[0]):
                    stalled = not self._claim_chunked(
                        self.waiting.popleft())
                    continue
                bucket = _bucket(self._ctx_len(self.waiting[0]),
                                 self.buckets)
                wave: List[Request] = []
                slots: List[int] = []
                rest: List[Request] = []
                while self.waiting and self.free_slots and not stalled \
                        and (self.max_wave is None
                             or len(wave) < self.max_wave):
                    req = self.waiting.popleft()
                    if self._use_chunked(req):
                        stalled = not self._claim_chunked(req)
                        continue
                    if _bucket(self._ctx_len(req), self.buckets) != bucket:
                        rest.append(req)
                        continue
                    slot = self._wave_claim(req)
                    if slot is None:          # block pool dry
                        self.waiting.appendleft(req)
                        stalled = True
                    else:
                        wave.append(req)
                        slots.append(slot)
                self.waiting.extendleft(reversed(rest))
                if wave:
                    dispatched.append(
                        (wave, slots,
                         self._dispatch_wave(wave, slots, bucket)))
            for wave, slots, first in dispatched:
                self._complete_wave(wave, slots, first)
                if on_wave is not None:
                    on_wave()

    def _dispatch_wave(self, wave: List[Request], slots: List[int],
                       bucket: int) -> torch.Tensor:
        """Enqueue one wave's prefill + inserts; returns the first
        tokens as a device tensor, not yet fetched."""
        n = len(wave)
        tokens_b = np.zeros((n, bucket), np.int64)
        true_lens = np.ones((n,), np.int64)
        for i, req in enumerate(wave):
            ctx = self._ctx(req)
            tokens_b[i, :len(ctx)] = ctx
            true_lens[i] = len(ctx)
        tokens = self._upload(tokens_b)
        lens = self._upload(true_lens)
        prefix, logits = kvcache.prefill_batch(
            self.params, tokens, lens, self.cfg,
            plain_attention=self.plain_attention, qweights=self.qweights)
        first = sampling.sample(logits, self.sampling_params,
                                self.generator)
        table = self.table_device()
        for w, slot in enumerate(slots):
            kvcache.insert(self.cache,
                           {"k": prefix["k"][:, w], "v": prefix["v"][:, w]},
                           slot, lens[w], first[w], table)
        return first

    def _complete_wave(self, wave: List[Request], slots: List[int],
                       first_dev: torch.Tensor) -> None:
        first = first_dev.tolist()             # host sync for THIS wave
        now = time.time()
        for req, slot, tok in zip(wave, slots, first):
            req.slot = slot
            req.tokens.append(tok)
            if req.first_token_s is None:
                req.first_token_s = now
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

    def _claim_chunked(self, req: Request) -> bool:
        """Claim a slot for an incremental prefill: look up the prefix
        cache, map a hit's shared blocks into the slot's table row (no
        row copies; a partially filled shared block is copied on write
        first, since the suffix prefill writes into it), and queue the
        remaining chunks. The claim stamps the slot's length to max_len
        (:func:`kvcache.claim_slot`), so interleaved bursts' writes for
        this not-yet-active slot land in the trash block. False when the
        pool is too dry: the request goes back to the queue's head. A
        resume looks up and prefills its whole context (:meth:`_ctx`)."""
        ctx = self._ctx(req)
        idx = self._prefix_index
        hit = idx.lookup(ctx) if idx is not None else None
        cached = n_shared = partial = 0
        shared: List[int] = []
        if hit is not None:
            payload, cached = hit
            n_shared, partial = divmod(cached, self.kv_block)
            # Pin the shared blocks BEFORE any dry-pool eviction:
            # _alloc_blocks may evict the hit's own entry, and an
            # unpinned block could come straight back as a fresh one,
            # aliased at two table positions.
            shared = list(payload[:n_shared])
            for b in shared:
                self.allocator.incref(b)
        new_blocks = self._alloc_blocks(
            max(self._need_blocks(req) - n_shared, 0))
        if new_blocks is None:
            for b in shared:                  # unpin; retry next pass
                self.allocator.decref(b)
            self.waiting.appendleft(req)
            return False
        slot = self.free_slots.pop(0)
        req.slot = slot
        row = self.block_table[slot]
        row[:] = self.n_kv_blocks
        if hit is not None:
            self.prefix_hits += 1
            row[:n_shared] = shared
            if partial:
                # Copy the partial shared block before the suffix
                # prefill writes into it (its owner keeps ref > 1).
                kvcache.copy_block(self.cache, payload[n_shared],
                                   new_blocks[0])
                self.cow_copies += 1
        elif idx is not None and idx.eligible(ctx):
            self.prefix_misses += 1
        row[n_shared:n_shared + len(new_blocks)] = new_blocks
        self._table_dirty = True
        kvcache.claim_slot(self.cache, slot, self.max_len)
        if req.tokens:
            req.resumed_len = cached
        else:
            req.cached_len = cached
        self.chunking.append(_ChunkState(req=req, pos=cached,
                                         total=len(ctx), ctx=ctx))
        return True

    def prefill_chunk_step(self) -> bool:
        """Run ONE chunk of the head chunked prefill. The big-cache read
        covers the span rung of the chunk's offset. On the final chunk
        the request's first token is fetched (host sync), the slot joins
        the decoding slots, and the request may retire at once. Returns
        True if a chunk ran."""
        if not self.chunking:
            return False
        st = self.chunking[0]
        req = st.req
        C = self.prefill_chunk
        start = st.pos
        n_valid = min(C, st.total - start)
        final = start + n_valid >= st.total
        chunk = np.zeros((C,), np.int64)
        chunk[:n_valid] = st.ctx[start:start + n_valid]
        tok_dev = kvcache.prefill_chunk(
            self.params, self.cache, self._upload(chunk), start, n_valid,
            req.slot, st.total if final else self.max_len, self.cfg,
            self.sampling_params, self.table_device(), final=final,
            span=self._span_arg(self._span_for(start)),
            generator=self.generator, plain_attention=self.plain_attention,
            qweights=self.qweights)
        req.n_chunks += 1
        st.pos += n_valid
        if not final:
            return True
        tok = int(tok_dev)                     # host sync
        self.chunking.popleft()
        req.tokens.append(tok)
        if req.first_token_s is None:          # once per request
            req.first_token_s = time.time()
        self.slot_req[req.slot] = req
        self._store_prefix(st.ctx, req.slot)
        if self._req_finished(req, tok):
            self._retire(req)
        return True

    # -- prefix cache ------------------------------------------------------

    def _store_prefix(self, ctx: List[int], slot: int) -> int:
        """Install ``ctx``'s chunk-aligned prefix (a prompt, or a
        resume's prompt + committed tokens), over the slot's resident
        rows, into the prefix cache unless it is already resident.
        Returns the rows installed (0 on every skip: no index, a prefix
        shorter than one chunk, already covered, a dry pool).
        Only chunk-path prompts are stored, so a later hit replays the
        chunk program's own rows.

        The slot's full blocks over the prefix are increfed and become
        the entry's payload; a trailing partial block is copied on share,
        since the slot (still alive) keeps writing into its own copy
        past the prefix."""
        idx = self._prefix_index
        if idx is None:
            return 0
        n = (len(ctx) // idx.block) * idx.block
        if n < idx.block:
            return 0
        covered = idx.lookup(ctx)
        if covered is not None and covered[1] >= n:
            return 0
        n_full, partial = divmod(n, self.kv_block)
        blocks = self.block_table[slot, :n_full + (1 if partial else 0)
                                  ].tolist()
        if partial:
            cow = self._alloc_blocks(1)
            if cow is None:                    # pool dry: skip storing
                return 0
            kvcache.copy_block(self.cache, blocks[n_full], cow[0])
            self.cow_copies += 1
            blocks[n_full] = cow[0]
        for b in blocks[:n_full]:
            self.allocator.incref(b)
        for payload in idx.insert_entry(ctx, n, tuple(blocks)):
            self.prefix_evictions += 1
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
        return (self._prefix_index is not None
                and self._prefix_index.eligible(prompt)
                and max_new_tokens > 1
                and self._resumable(len(prompt) + 1))

    def export_prefix_for(self, req: Request) -> Optional[Dict[str, Any]]:
        """Host copy of the retired request's stored prefix, for a
        decode-tier replica: ``cached_len``, ``kv_block``, ``n_blocks``,
        ``salt`` and ``tensors`` (numpy, [L, nb, ...] per pool,
        :func:`kvcache.export_blocks`). The entry's blocks stay resident
        here, ref-counted and LRU like any stored prefix. Float planes
        are widened to float32 on the device before the host copy (as
        the reference widens bfloat16 at encode: the wire bytes are the
        same, and numpy needs no bfloat16 type). None when no prefix of
        the request is resident (the caller serves it single-tier)."""
        idx = self._prefix_index
        if idx is None:
            return None
        hit = idx.lookup(self._ctx(req))
        if hit is None:
            return None
        payload, cached = hit
        ids = torch.tensor(payload, dtype=torch.long, device=self.device)
        tensors = {}
        for name, v in kvcache.export_blocks(self.cache, ids).items():
            if v.is_floating_point():
                v = v.float()
            tensors[name] = v.cpu().numpy()
        return {"cached_len": cached, "kv_block": self.kv_block,
                "n_blocks": len(payload), "salt": b"", "tensors": tensors}

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
        if idx is None:
            return 0
        if export.get("kv_block") != self.kv_block:
            return 0            # geometry mismatch: resume cold
        cached = int(export["cached_len"])
        nb = int(export["n_blocks"])
        tensors = export["tensors"]
        if nb != -(-cached // self.kv_block) or nb < 1 or set(tensors) != {
                n for n in ("k", "v", "k_scale", "v_scale")
                if n in self.cache}:
            return 0            # int8 against float, or a torn export
        for name, have in tensors.items():
            want = self.cache[name]
            # The wire carries float planes as float32 (exact; the
            # scatter casts back); int8 against float is a real
            # quantization mismatch.
            hdt = str(have.dtype)
            ok_dtype = (hdt == str(want.dtype).removeprefix("torch.")
                        or (hdt == "float32" and want.is_floating_point()))
            if tuple(have.shape) != (want.shape[0], nb) + tuple(
                    want.shape[2:]) or not ok_dtype:
                return 0        # model/dtype mismatch: resume cold
        covered = idx.lookup(ctx, salt)
        if covered is not None and covered[1] >= cached:
            return covered[1]   # already at least as warm
        blocks = self._alloc_blocks(nb)
        if blocks is None:
            return 0            # pool dry: resume cold
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)
        kvcache.import_blocks(self.cache, ids, {
            name: torch.from_numpy(np.require(arr, requirements="CW")).to(
                self.device)
            for name, arr in tensors.items()})
        for payload in idx.insert_entry(ctx, cached, tuple(blocks), salt):
            self.prefix_evictions += 1
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
        if req.slot is not None:
            self.slot_req.pop(req.slot, None)
            self.free_slots.append(req.slot)
            self._free_slot_blocks(req.slot)
            req.slot = None

    def dispatch_decode_burst(self, max_burst: int = 8
                              ) -> Optional[BurstHandle]:
        """Enqueue one decode burst WITHOUT fetching its tokens; pass the
        handle to :meth:`complete_decode_burst` later. A streaming
        server dispatches burst k+1 before fetching burst k, so the card
        decodes while the host streams. The burst length is capped so
        no active slot's cache can overflow (counting tokens in flight)
        and rounded down to a power of two. Returns None when there is
        nothing to decode."""
        if not self.slot_req:
            return None
        k = max_burst
        need = 0
        for req in self.slot_req.values():
            k = min(k, self.max_len - self._slot_rows(req))
            need = max(need, req.max_new_tokens - len(req.tokens)
                       - self._inflight_tokens)
        if k < 1 or need < 1:
            return None
        k = 1 << (k.bit_length() - 1)
        parts: List[Tuple[torch.Tensor, List[int]]] = []
        for span, slots in self._span_groups():
            active = np.zeros((self.n_slots,), bool)
            active[slots] = True
            toks = kvcache.decode_burst_staged(
                self.params, self.cache, self._upload(active), k,
                self.cfg, self.sampling_params, self.table_device(),
                span=self._span_arg(span), generator=self.generator,
                plain_attention=self.plain_attention, qweights=self.qweights)
            parts.append((toks, slots))
        self._inflight_tokens += k
        return BurstHandle(parts=parts, k=k, slot_req=dict(self.slot_req))

    def complete_decode_burst(self, handle: BurstHandle
                              ) -> Dict[int, List[int]]:
        """Fetch a dispatched burst's tokens (host sync) and append or
        retire per request, using the slot->request snapshot taken at
        dispatch. Tokens past a request's EOS or budget are discarded.
        Returns {rid: [tokens...]}."""
        fetched = [(toks.cpu().numpy(), slots)
                   for toks, slots in handle.parts]
        self._inflight_tokens -= handle.k
        out: Dict[int, List[int]] = {}
        for toks, slots in fetched:
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
        """Resolve (and advance) this request's drafter rung: "ngram"
        (the factory seam; test drafters ride it too) until acceptance
        collapses in that mode (>= spec_min_drafted drafted below
        spec_min_rate accepted), then "off" for good."""
        if req.spec_off:
            return "off"
        if req.spec_mode is None:
            req.spec_mode = "ngram"
        if (req.spec_mode_drafted >= self.spec_min_drafted
                and req.spec_mode_accepted
                < self.spec_min_rate * req.spec_mode_drafted):
            req.spec_mode = "off"
            req.spec_off = True
        return req.spec_mode

    def _draft_for(self, req: Request) -> List[int]:
        """This request's draft through the per-request factory seam.
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
        """One draft-and-verify round for every active slot: the drafter
        proposes up to K tokens per slot, one verify call per span group
        scores the K+1 window positions, and each slot commits its
        matched run plus the correction token (fetched at once: the next
        round's window needs them). Returns {rid: [tokens...]}, or None
        when no active slot drafted (all missed, collapsed or without
        K+1 rows of headroom): a plain burst then does the same work
        cheaper."""
        K = self.spec_k
        if not self.slot_req or K <= 0:
            return None
        draft = np.zeros((self.n_slots, K), np.int64)
        n_draft = np.zeros((self.n_slots,), np.int64)
        dlen: Dict[int, int] = {}
        for slot, req in self.slot_req.items():
            # A slot within K+1 rows of max_len drafts nothing: its one
            # correction row stays in bounds and its spare window rows
            # land in the trash block, while other slots keep drafting.
            if len(req.prompt) + len(req.tokens) + K + 1 > self.max_len:
                continue
            if self._spec_mode(req) == "off":
                continue
            d = self._draft_for(req)
            if d:
                n_draft[slot] = len(d)
                draft[slot, :len(d)] = d
                dlen[slot] = len(d)
        if not dlen:
            return None
        draft_dev = self._upload(draft)
        n_draft_dev = self._upload(n_draft)
        parts = []
        for span, slots in self._span_groups():
            active = np.zeros((self.n_slots,), bool)
            active[slots] = True
            toks, n_commit = kvcache.verify_draft_staged(
                self.params, self.cache, draft_dev, n_draft_dev,
                self._upload(active), K, self.cfg, self.table_device(),
                span=self._span_arg(span),
                plain_attention=self.plain_attention, qweights=self.qweights)
            self.verify_calls += 1
            parts.append((slots, toks, n_commit))
        out: Dict[int, List[int]] = {}
        drafted = accepted = 0
        for slots, toks_dev, commit_dev in parts:
            toks = toks_dev.cpu().numpy()               # host sync
            n_commit = commit_dev.cpu().numpy()
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
                drafted += nd
                accepted += acc
                out[req.rid] = emitted
        self._spec_drafted_total += drafted
        self._spec_accepted_total += accepted
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
        finished list."""
        while self.waiting or self.chunking or self.slot_req:
            self.step_burst(max_burst)
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
        self.allocator.reset()
        self.block_table[:] = self.n_kv_blocks
        self._table_dirty = True
        self.cache["length"].zero_()

    def generate(self, prompts: List[List[int]],
                 max_new_tokens: int = 128) -> List[List[int]]:
        ids = [self.add_request(p, max_new_tokens) for p in prompts]
        self.run_to_completion()
        by_rid = {r.rid: r for r in self.finished}
        return [by_rid[i].tokens for i in ids]


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
