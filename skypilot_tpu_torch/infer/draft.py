"""Model-backed speculative drafter: a small model riding the engine's
own paged programs.

Counterpart of ``skypilot_tpu/infer/draft.py``. The n-gram drafter only
pays on repetitive text. :class:`DraftEngine` serves a real draft model
(a llama3-400m-class config, or a truncated-layer draft of the target:
:func:`truncated_draft`) and plugs into the engine's
``spec_decode_burst`` as a batched drafter: K greedy tokens per active
slot per round from one staged burst (``kvcache.decode_burst_staged``
on the draft config, the program the engine bursts with, at the draft
model's size).

* **KV in lockstep.** The drafter owns a paged block pool (the
  ``kvcache`` layout, a block table whose last column is the sentinel),
  or with ``kv_block`` 0 a contiguous cache of one ``max_len`` row per
  slot (``kvcache.init_cache``), whatever layout the target uses.
  Slot ``s`` of the drafter mirrors slot ``s`` of the engine; its rows
  advance as the drafter rolls out and roll back as the verifier's do,
  by a length that does not advance (:func:`kvcache.sync_slots`), never
  by a row copy or a block move. Rows are tracked by content on the
  host (``_SlotState.toks``: the token behind each resident row), so
  after a verify commits its tokens the longest valid row prefix is
  found by comparison and everything past it is dead by bookkeeping.
* **Correctness never depends on the draft.** The verifier is greedy
  and unchanged; a bad draft only wastes verify positions, and any
  mismatch of state resolves to a rollback and a re-ingest.

The async pipeline (the engine's ``spec_pipeline``): while the verify
calls are in flight, the engine calls :meth:`DraftEngine.rollout` to
enqueue the next round's draft burst against the drafter's own chain
(it assumes the current draft is accepted in full and predicts the
verifier's bonus token as its own next greedy token). Nothing is
fetched then: the rollout's tokens are read at the next
:meth:`DraftEngine.draft_batch`, which checks them against what the
verifier committed. A full match serves the next draft with no new
device work; a mispredicted round is dropped on the host.

Deliberate differences from the reference:

- No spare slot: the port's engine keeps none (no wave padding), so the
  draft pool has ``n_slots`` table rows and, by default, one max_len
  row of blocks per slot. The sentinel id addresses the cache's trash
  block (``kvcache`` docstring), so a released slot's writes land
  there.
- On the card a paged pool takes the block length that K1's multi-row
  body reads (``engine.kv_block_len``), not the reference's largest
  divisor. A contiguous pool's rows at or past ``max_len`` land in its
  trash slot (``kvcache`` docstring).
- :meth:`DraftEngine.warm_programs` runs against a free draft slot
  (its table row all-sentinel; contiguous: any free slot) instead of a
  spare one, and restores the lengths, pending tokens and generator
  stream afterwards.
- Sampling draws from an explicit ``torch.Generator`` on the engine's
  device (greedy drafting never reads it).
- No ``kv_blocks``, ``span_buckets`` or ``ingest_chunk`` options: the
  pool is always one max_len row of blocks per slot (so it never runs
  dry), the span ladder is the engine's default and catch-up rows land
  in chunks of :data:`INGEST_CHUNK`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.infer import engine as eng
from skypilot_tpu_torch.infer import kvcache, sampling
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import attribution as attribution_lib
from skypilot_tpu_torch.observability import flight as flight_lib

# Catch-up rows land in chunks of this width (capped at max_len).
INGEST_CHUNK = 256

@dataclasses.dataclass
class _SlotState:
    """Host mirror of one draft slot's device state. ``toks[i]`` is the
    token whose K/V occupies row ``i`` (committed and speculative rows
    alike: validity is decided by comparison with the verifier's
    committed context, never trusted); ``last`` is the pending token the
    next rollout step consumes (the device ``last_token``);
    ``confirmed`` bounds how far the committed context has already been
    matched, so a steady-state sync compares only the new tokens."""
    toks: List[int]
    last: Optional[int]
    confirmed: int = 0


class DraftEngine:
    """A small model, its paged KV cache and the three draft programs.

    Not a request scheduler: the engine owns admission, slots and
    retirement, and drives this through :meth:`draft_batch` (K draft
    tokens per slot, the draft KV synced to the verifier's committed
    state first), :meth:`rollout` (the pipelined predraft while a verify
    is in flight) and :meth:`release` (a slot retired or preempted: its
    blocks free, its state drops). All calls come from the engine's
    thread, and every program is enqueued on the current CUDA stream,
    behind the engine's own.
    """

    def __init__(self, params: llama.Params, cfg: llama.LlamaConfig,
                 n_slots: int, max_len: int, kv_int8: bool = False,
                 qweights: Optional[kvcache.QWeights] = None,
                 kv_block: Optional[int] = None, seed: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = eng._to_device(params, self.device)
        self.qweights = (eng._to_device(qweights, self.device)
                         if qweights is not None else None)
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        # The engine's paged idiom: host-authoritative table with a
        # dirty-tracked device copy, sentinel last column. The pool
        # holds one full-length allocation per slot: the draft model's
        # KV is small, and a drafter must never limit admission.
        # kv_block 0: the contiguous layout, no table.
        if kv_block is None:
            kv_block = int(os.environ.get("SKYTPU_DRAFT_KV_BLOCK",
                                          "256") or 0)
        self.paged = kv_block > 0
        self._table_dev: Optional[torch.Tensor] = None
        self._table_dirty = self.paged
        if self.paged:
            self.kv_block: Optional[int] = eng.paged_block_len(
                max_len, kv_block, self.device, kv_int8)
            nb = max_len // self.kv_block
            self.blocks_per_slot = nb
            self.n_kv_blocks = n_slots * nb
            self.allocator: Optional[kvcache.BlockAllocator] = (
                kvcache.BlockAllocator(self.n_kv_blocks))
            self.block_table: Optional[np.ndarray] = np.full(
                (n_slots, nb + 1), self.n_kv_blocks, np.int32)
            self.cache = kvcache.init_paged_cache(
                cfg, n_slots, self.n_kv_blocks, self.kv_block, self.device,
                kv_int8=kv_int8)
        else:
            self.kv_block = None
            self.blocks_per_slot = 0
            self.n_kv_blocks = 0
            self.allocator = None
            self.block_table = None
            self.cache = kvcache.init_cache(cfg, n_slots, max_len,
                                            kv_int8=kv_int8,
                                            device=self.device)
        self.span_ladder = eng._span_ladder(None, max_len)
        self.ingest_chunk = min(INGEST_CHUNK, max_len)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._sp = sampling.SamplingParams()     # drafting is argmax-only
        self._state: Dict[int, _SlotState] = {}
        # The one deferred rollout (the pipelined predraft): (device
        # tokens [k, slots], slots, k). At most one is outstanding: the
        # engine runs one verify round at a time.
        self._pending_roll: Optional[
            Tuple[torch.Tensor, List[int], int]] = None
        # On the card, an event recorded behind the predraft's work: its
        # pinned, non-blocking uploads and kernels may still be queued.
        self._pending_done: Optional[torch.cuda.Event] = None
        # Introspection counters (tests and the bench's structure).
        self.rollouts = 0            # rollout bursts dispatched
        self.ingest_chunks = 0       # catch-up chunks
        self.rollbacks = 0           # speculative rows discarded
        self.reuse_hits = 0          # rounds served from a predraft
        self.decode_programs: set = set()
        # The drafter's own compile watch and device-time calibrator:
        # draft program identity is drafter-scoped, and the engine's
        # "draft" flight records look their dev_ms_est up here.
        self.compile_watch = flight_lib.CompileWatch()
        self.devtime = attribution_lib.DeviceTimeCalibrator(
            device=self.device)
        self.compile_watch.calibrator = self.devtime
        watch = self.compile_watch.wrap
        self._rollout_fn = watch("draft_rollout", self._rollout_program,
                                 ("k", "span"))
        self._ingest_fn = watch("draft_ingest", self._ingest_program,
                                ("final", "span"))
        self._sync_fn = watch("draft_sync", kvcache.sync_slots)

    # -- paged table -------------------------------------------------------

    def table_device(self) -> Optional[torch.Tensor]:
        if not self.paged:
            return None
        if self._table_dirty or self._table_dev is None:
            self._table_dev = eng.upload(self.block_table.copy(),
                                         self.device)
            self._table_dirty = False
        return self._table_dev

    @property
    def blocks_used(self) -> int:
        return self.allocator.used if self.paged else 0

    # -- span buckets ------------------------------------------------------

    def _span_for(self, rows: int) -> int:
        for s in self.span_ladder:
            if rows <= s:
                return s
        return self.span_ladder[-1]

    def _span_arg(self, span: int) -> Optional[int]:
        return None if span >= self.max_len else span

    # -- slot lifecycle ----------------------------------------------------

    def claimed(self, slot: int) -> bool:
        return slot in self._state

    def _acquire(self, slot: int) -> _SlotState:
        """Fresh state and a full-length block allocation for a slot the
        engine started drafting on (the pool holds one per slot; a
        contiguous slot owns its row already)."""
        if self.paged:
            row = self.block_table[slot]
            row[:] = self.n_kv_blocks
            blocks = [self.allocator.alloc()
                      for _ in range(self.blocks_per_slot)]
            row[:len(blocks)] = blocks
            self._table_dirty = True
        st = _SlotState(toks=[], last=None, confirmed=0)
        self._state[slot] = st
        return st

    def release(self, slot: int) -> None:
        """A slot retired or preempted on the engine: free its draft
        blocks and drop its state. Its table row goes all-sentinel
        (later rollouts' writes for it land in the trash block) and a
        re-acquire starts from zero rows, re-ingesting what it reads."""
        st = self._state.pop(slot, None)
        if st is None or not self.paged:
            return
        row = self.block_table[slot]
        for b in row[row < self.n_kv_blocks].tolist():
            self.allocator.decref(b)
        row[:] = self.n_kv_blocks
        self._table_dirty = True

    def reset(self) -> None:
        """Engine reset: drop all state wholesale (counts may be
        inconsistent after a failure, as the engine's allocator's). A
        deferred predraft is dropped only once its queued uploads and
        kernels have landed, so nothing the host rewrites next (the
        table, the lengths, the staging buffers) races them; on a card
        whose context a device fault poisoned that wait raises, and the
        server's fail-all path takes over."""
        if self._pending_done is not None:
            self._pending_done.synchronize()
        self._state.clear()
        self._pending_roll = None
        self._pending_done = None
        if self.paged:
            self.allocator.reset()
            self.block_table[:] = self.n_kv_blocks
            self._table_dirty = True
        self.cache["length"].zero_()

    # -- drafting ----------------------------------------------------------

    def draft_batch(self, ctxs: Dict[int, Sequence[int]],
                    k: int) -> Dict[int, List[int]]:
        """Up to ``k`` draft tokens per slot, each slot's draft KV synced
        to the verifier's committed context first.

        ``ctxs``: slot -> the request's committed context (prompt and
        committed tokens). Per slot, the longest row prefix backed by
        committed tokens stays (an accepted round's rows, and a matching
        predraft's, are valid by content); everything past it is
        discarded by one batched length and pending-token write; missing
        rows ingest through the chunk program. When a deferred predraft
        (:meth:`rollout`) matched what the verifier committed, the round
        is served with no new device work."""
        self._apply_pending()
        k = max(k, 1)
        preds: Dict[int, List[int]] = {}
        fix: Dict[int, Tuple[int, int]] = {}
        ctx_by_slot: Dict[int, List[int]] = {}
        need_roll: List[int] = []
        for slot, ctx in ctxs.items():
            # The engine hands a fresh list each round (engine._ctx).
            if not isinstance(ctx, list):
                ctx = list(ctx)
            if not ctx:
                preds[slot] = []
                continue
            ctx_by_slot[slot] = ctx
            st = self._state.get(slot)
            if st is None:
                st = self._acquire(slot)
            p = self._sync_slot(slot, st, ctx, fix)
            preds[slot] = p
            if len(p) >= k:
                self.reuse_hits += 1
            elif len(st.toks) + k <= self.max_len:
                need_roll.append(slot)
        if fix:
            self._dispatch_sync(fix)
        if need_roll:
            toks = self._dispatch_rollout(need_roll, k)
            # The draft path's fetch: the verify window needs these
            # tokens on the host.
            self._apply_rollout(toks.cpu().numpy(), need_roll, k)
            for slot in need_roll:
                st = self._state[slot]
                M = len(ctx_by_slot[slot])
                preds[slot] = st.toks[M:] + [st.last]
        return {s: p[:k] for s, p in preds.items()}

    def rollout(self, slots: Sequence[int], k: int) -> bool:
        """The pipelined predraft: enqueue one ``k``-step rollout for
        ``slots`` without fetching (the engine calls this while its
        verify is in flight; the tokens are fetched, and checked against
        what the verify committed, at the next :meth:`draft_batch`).
        Slots without state or row headroom are skipped. Returns whether
        anything was dispatched. No host sync on this path."""
        self._apply_pending()
        live = [s for s in slots
                if s in self._state
                and self._state[s].last is not None
                and len(self._state[s].toks) + k <= self.max_len]
        if not live or k <= 0:
            return False
        toks = self._dispatch_rollout(live, k)
        self._pending_roll = (toks, live, k)
        if self.device.type == "cuda":
            self._pending_done = torch.cuda.Event()
            self._pending_done.record()
        return True

    # -- internals ---------------------------------------------------------

    def _apply_pending(self) -> None:
        if self._pending_roll is None:
            return
        toks, slots, k = self._pending_roll
        self._pending_roll = None
        self._pending_done = None
        # The deferred fetch: the card ran this behind the verify while
        # the host fetched and committed that round.
        self._apply_rollout(toks.cpu().numpy(), slots, k)

    def _apply_rollout(self, arr: np.ndarray, slots: Sequence[int],
                       k: int) -> None:
        for slot in slots:
            st = self._state.get(slot)
            if st is None:           # released mid-flight: rows dead
                continue
            p = [int(arr[j, slot]) for j in range(k)]
            st.toks.append(st.last)
            st.toks.extend(p[:-1])
            st.last = p[-1]

    def _sync_slot(self, slot: int, st: _SlotState, ctx: List[int],
                   fix: Dict[int, Tuple[int, int]]) -> List[int]:
        """Sync one slot to the committed context; returns the still
        valid predictions beyond it ([] after a rollback)."""
        M = len(ctx)
        n = len(st.toks)
        have = n + (1 if st.last is not None else 0)
        if have >= M:
            # Compare without building toks + [last]: seq[i] is toks[i]
            # below n and last at n.
            i = st.confirmed
            while i < M and (st.toks[i] if i < n
                             else st.last) == ctx[i]:
                i += 1
            if i == M:
                # Full match: rows 0..M-2 are backed by committed
                # tokens, the tail is the drafter's own consistent
                # chain, whose outputs past the context are the live
                # predictions.
                st.confirmed = M - 1
                preds = st.toks[M:]
                if st.last is not None and n >= M:
                    # ``last`` is a prediction only past the context
                    # (n >= M); at n == M - 1 it is the committed
                    # pending token.
                    preds = preds + [st.last]
                return preds
        # Mismatch (or a fresh or short slot): roll back to the longest
        # row prefix backed by committed tokens, a bookkeeping write
        # only (the rows never move).
        v = st.confirmed
        limit = min(len(st.toks), M - 1)
        while v < limit and st.toks[v] == ctx[v]:
            v += 1
        if v < len(st.toks):
            self.rollbacks += len(st.toks) - v
            del st.toks[v:]
        st.last = None
        if v < M - 1:
            self._ingest(slot, ctx, v, M - 1)
            st.toks.extend(ctx[v:M - 1])
        st.last = ctx[M - 1]
        st.confirmed = M - 1
        fix[slot] = (M - 1, ctx[M - 1])
        return []

    def _ingest(self, slot: int, ctx: List[int], start: int,
                upto: int) -> None:
        """Rows [start, upto) for the tokens ctx[start:upto], in chunks
        of the ingest width, through ``kvcache.prefill_chunk`` with
        ``final=False`` (no sampling), each stamping the row count."""
        C = self.ingest_chunk
        pos = start
        while pos < upto:
            n = min(C, upto - pos)
            chunk = np.zeros((C,), np.int64)
            chunk[:n] = ctx[pos:pos + n]
            sarg = self._span_arg(self._span_for(pos))
            self.decode_programs.add(("ingest", False, sarg))
            self._ingest_fn(eng.upload(chunk, self.device), pos, n, slot,
                            pos + n, final=False, span=sarg)
            self.ingest_chunks += 1
            pos += n

    def _dispatch_sync(self, fix: Dict[int, Tuple[int, int]]) -> None:
        active = np.zeros((self.n_slots,), bool)
        lengths = np.zeros((self.n_slots,), np.int32)
        tokens = np.zeros((self.n_slots,), np.int64)
        for slot, (ln, tok) in fix.items():
            active[slot] = True
            lengths[slot] = ln
            tokens[slot] = tok
        self._sync_fn(self.cache, eng.upload(active, self.device),
                      eng.upload(lengths, self.device),
                      eng.upload(tokens, self.device))

    def _dispatch_rollout(self, slots: Sequence[int],
                          k: int) -> torch.Tensor:
        """One ``k``-step staged burst of the draft model over ``slots``
        (the rest inactive); returns its tokens [k, slots] on the
        device, unfetched."""
        active = np.zeros((self.n_slots,), bool)
        rows_max = 1
        for s in slots:
            active[s] = True
            rows_max = max(rows_max, len(self._state[s].toks))
        sarg = self._span_arg(self._span_for(rows_max))
        self.decode_programs.add(("rollout", k, sarg))
        toks = self._rollout_fn(eng.upload(active, self.device), k=k,
                                span=sarg)
        self.rollouts += 1
        return toks

    def _rollout_program(self, active: torch.Tensor, *, k: int,
                         span: Optional[int]) -> torch.Tensor:
        return kvcache.decode_burst_staged(
            self.params, self.cache, active, k, self.cfg, self._sp,
            self.table_device(), span=span, generator=self.generator,
            qweights=self.qweights)

    def _ingest_program(self, chunk: torch.Tensor, start: int,
                        n_valid: int, slot: int, new_len: int, *,
                        final: bool, span: Optional[int]):
        return kvcache.prefill_chunk(
            self.params, self.cache, chunk, start, n_valid, slot, new_len,
            self.cfg, self._sp, self.table_device(), final=final,
            span=span, generator=self.generator, qweights=self.qweights)

    # -- warmup ------------------------------------------------------------

    def warm_programs(self, k: int) -> int:
        """Dispatch the drafter's reachable programs once: rollouts at
        ``k`` and ``k + 1`` (the pipelined predraft's width) and the
        ingest chunk at every span rung, and the sync program, against
        a free slot whose table row is all-sentinel (contiguous: any
        free slot), inside
        :func:`engine.warm_sweep` as the engine's sweep runs. Raises
        :class:`engine.NoFreeSlotError` when every draft slot is
        claimed. Returns the keys first dispatched."""
        spare = eng.warm_slot(
            (s for s in range(self.n_slots) if s not in self._state),
            self.block_table, self.n_kv_blocks)
        before = self.compile_watch.count
        k = max(int(k), 1)
        active = np.zeros((self.n_slots,), bool)
        active[spare] = True
        active_dev = eng.upload(active, self.device)
        with eng.warm_sweep(self.compile_watch, self.cache, self.generator):
            chunk = eng.upload(np.zeros((self.ingest_chunk,), np.int64),
                               self.device)
            for span in self.span_ladder:
                sarg = self._span_arg(span)
                for kk in sorted({k, k + 1}):
                    self._rollout_fn(active_dev, k=kk, span=sarg)
                self._ingest_fn(chunk, 0, 1, spare, 0, final=False,
                                span=sarg)
            zeros = eng.upload(np.zeros((self.n_slots,), np.int64),
                               self.device)
            self._sync_fn(self.cache,
                          eng.upload(np.zeros((self.n_slots,), bool),
                                     self.device), zeros, zeros)
        return self.compile_watch.count - before

    def declare_warmup_complete(self) -> None:
        self.compile_watch.declare_warm()

    def hbm_bytes(self) -> int:
        """Device-resident bytes the drafter holds (its weights and KV
        pool): the engine's HBM ledger publishes them as
        ``draft_pool``."""
        return (attribution_lib.tensor_bytes(self.params)
                + attribution_lib.tensor_bytes(self.qweights)
                + attribution_lib.tensor_bytes(self.cache))

    def stats(self) -> Dict[str, int]:
        return {
            "rollouts": self.rollouts,
            "ingest_chunks": self.ingest_chunks,
            "rollbacks": self.rollbacks,
            "reuse_hits": self.reuse_hits,
            "slots": len(self._state),
            "blocks_used": self.blocks_used,
            "pending": 1 if self._pending_roll is not None else 0,
        }


# ---------------------------------------------------------------------------
# Draft-model construction.

def truncated_draft(params: llama.Params, cfg: llama.LlamaConfig,
                    n_layers: int) -> Tuple[llama.Params,
                                            llama.LlamaConfig]:
    """The zero-training draft model: the target's first ``n_layers``
    decoder blocks and its embedding, norm and head. The blocks are
    views of the stacked per-layer tensors (no copies): they share the
    target's storage."""
    n_layers = max(1, min(int(n_layers), cfg.n_layers))
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    blocks = {name: w[:n_layers] for name, w in params["blocks"].items()}
    return dict(params, blocks=blocks), dcfg


def self_distilled_pair(params: llama.Params, cfg: llama.LlamaConfig,
                        draft_layers: int):
    """(target_params, draft_params, draft_cfg) at the distillation
    endpoint: the target's residual blocks past ``draft_layers`` get
    zeroed output projections (``wo`` and ``w_down``, cloned; the rest
    of the tree is shared with ``params``), so they pass the residual
    stream through unchanged and the truncated-layer draft agrees with
    the target exactly. The zeroed layers still pay their full matmul
    cost, so the target's decode cost is unchanged."""
    draft_layers = max(1, min(int(draft_layers), cfg.n_layers))
    blocks = dict(params["blocks"])
    for name in ("wo", "w_down"):
        w = blocks[name].clone()
        w[draft_layers:] = 0
        blocks[name] = w
    target = dict(params, blocks=blocks)
    draft, dcfg = truncated_draft(target, cfg, draft_layers)
    return target, draft, dcfg


def draft_engine_from_env(params: llama.Params, cfg: llama.LlamaConfig,
                          n_slots: int, max_len: int,
                          spec: Optional[str] = None,
                          kv_int8: bool = False, seed: int = 1,
                          device: DeviceLike = None
                          ) -> Optional[DraftEngine]:
    """The serving drafter from ``--draft-model`` /
    ``SKYTPU_DRAFT_MODEL``:

    * ``self:N``: the truncated-layer draft sharing the target's first
      N blocks (no extra weights);
    * a ``llama.CONFIGS`` name (e.g. ``llama3-400m``): a separate draft
      config with the target's vocabulary, drawn at random in its
      ``dtype`` on ``device`` from ``seed``;
    * unset or empty: no model drafter (n-gram stays the default).
    """
    spec = (spec if spec is not None
            else os.environ.get("SKYTPU_DRAFT_MODEL", "")).strip()
    if not spec:
        return None
    dev = resolve_device(device)
    if spec.startswith("self:"):
        n = int(spec.split(":", 1)[1])
        dparams, dcfg = truncated_draft(params, cfg, n)
    elif spec in llama.CONFIGS:
        dcfg = llama.CONFIGS[spec]
        if dcfg.vocab_size != cfg.vocab_size:
            dcfg = dataclasses.replace(dcfg, vocab_size=cfg.vocab_size)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dparams = llama.init_params(dcfg, gen, device=dev,
                                    dtype=dcfg.dtype)
    else:
        raise ValueError(
            f"SKYTPU_DRAFT_MODEL={spec!r}: expected 'self:N' or one "
            f"of {sorted(llama.CONFIGS)}")
    return DraftEngine(dparams, dcfg, n_slots=n_slots, max_len=max_len,
                       kv_int8=kv_int8, seed=seed, device=dev)
