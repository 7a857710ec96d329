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

Left for later slices of the port: the prefix cache, speculative
verify, int8 KV and weights, LoRA adapters, QoS, the flight recorder,
metrics, tracing and crash recovery. The JAX engine padded
admission waves to fixed row counts to avoid recompiles; PyTorch runs
eagerly, so the port dispatches each wave at its own size and keeps no
spare slot for padding rows.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.infer import kvcache, sampling
from skypilot_tpu_torch.models import llama


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


@dataclasses.dataclass
class _ChunkState:
    """A request mid-chunked-prefill: slot claimed, rows [0, pos)
    resident (completed chunks), first token not yet produced."""
    req: Request
    pos: int            # next row offset to prefill
    total: int          # len(prompt)


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


class InferenceEngine:
    """Single-model continuous-batching engine on one device.

    ``params`` are the model's tensors (``models/llama.py``), moved to
    ``device`` if they live elsewhere; serving passes them in
    ``cfg.dtype``. ``device`` defaults to the CUDA card and raises when
    there is none; tests pass ``"cpu"``. ``plain_attention`` runs the
    kernels' plain versions, the reference the kernel path is held to.
    """

    def __init__(self, params: llama.Params, cfg: llama.LlamaConfig,
                 n_slots: int = 8, max_len: int = 1024,
                 prompt_buckets: Tuple[int, ...] = (128, 512, 1024),
                 sampling_params: sampling.SamplingParams = sampling.SamplingParams(),
                 eos_id: Optional[int] = None, seed: int = 0,
                 max_wave: Optional[int] = None, kv_block: int = 256,
                 kv_blocks: Optional[int] = None, span_buckets=None,
                 prefill_chunk: Optional[int] = 512,
                 device: DeviceLike = None,
                 plain_attention: bool = False):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
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
        if kv_block <= 0:
            raise ValueError("the port serves the paged KV layout only: "
                             "kv_block must be > 0")
        # Largest divisor of max_len <= the requested block: the block
        # axis must tile max_len exactly.
        b = min(kv_block, max_len)
        while max_len % b:
            b -= 1
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
            cfg, n_slots, self.n_kv_blocks, self.kv_block, self.device)
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
                    max_new_tokens: int = 128) -> int:
        _bucket(len(prompt), self.buckets)   # validate length up front
        req = Request(rid=self._next_rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      submit_s=time.time(), eos_id=self.eos_id)
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

    def _wave_claim(self, req: Request) -> Optional[int]:
        """Claim a slot and its KV blocks; None when the pool is too
        dry (the caller re-queues and stalls admission)."""
        n = self._need_blocks(req)
        if self.allocator.available < n:
            return None
        blocks = [self.allocator.alloc() for _ in range(n)]
        slot = self.free_slots.pop(0)
        row = self.block_table[slot]
        row[:] = self.n_kv_blocks
        row[:len(blocks)] = blocks
        self._table_dirty = True
        return slot

    def _free_slot_blocks(self, slot: int) -> None:
        """Release a slot's blocks and clear its table row to the
        sentinel: later bursts' writes for the dead slot land in the
        trash block."""
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
                bucket = _bucket(len(self.waiting[0].prompt), self.buckets)
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
                    if _bucket(len(req.prompt), self.buckets) != bucket:
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
            tokens_b[i, :len(req.prompt)] = req.prompt
            true_lens[i] = len(req.prompt)
        tokens = self._upload(tokens_b)
        lens = self._upload(true_lens)
        prefix, logits = kvcache.prefill_batch(
            self.params, tokens, lens, self.cfg,
            plain_attention=self.plain_attention)
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

    def _use_chunked(self, req: Request) -> bool:
        return (self.prefill_chunk is not None
                and len(req.prompt) > self.prefill_chunk)

    def _claim_chunked(self, req: Request) -> bool:
        """Claim a slot and its KV blocks for an incremental prefill and
        queue its chunks; the claim stamps the slot's length to max_len
        (:func:`kvcache.claim_slot`), so interleaved bursts' writes for
        this not-yet-active slot land in the trash block. False when the
        pool is too dry: the request goes back to the queue's head."""
        slot = self._wave_claim(req)
        if slot is None:
            self.waiting.appendleft(req)
            return False
        req.slot = slot
        kvcache.claim_slot(self.cache, slot, self.max_len)
        self.chunking.append(_ChunkState(req=req, pos=0,
                                         total=len(req.prompt)))
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
        chunk[:n_valid] = req.prompt[start:start + n_valid]
        tok_dev = kvcache.prefill_chunk(
            self.params, self.cache, self._upload(chunk), start, n_valid,
            req.slot, st.total if final else self.max_len, self.cfg,
            self.sampling_params, self.table_device(), final=final,
            span=self._span_arg(self._span_for(start)),
            generator=self.generator, plain_attention=self.plain_attention)
        req.n_chunks += 1
        st.pos += n_valid
        if not final:
            return True
        tok = int(tok_dev)                     # host sync
        self.chunking.popleft()
        req.tokens.append(tok)
        if req.first_token_s is None:
            req.first_token_s = time.time()
        self.slot_req[req.slot] = req
        if self._req_finished(req, tok):
            self._retire(req)
        return True

    # -- decoding ----------------------------------------------------------

    def _req_finished(self, req: Request, tok: int) -> bool:
        if req.eos_id is not None and tok == req.eos_id:
            return True
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return len(req.prompt) + len(req.tokens) >= self.max_len

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
                plain_attention=self.plain_attention)
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
        admission."""
        handle = self.dispatch_decode_burst(max_burst)
        if handle is None:
            return {}
        return self.complete_decode_burst(handle)

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
