"""Paged KV cache: wave prefill, insert, chunked prefill and the staged
decode burst.

Counterpart of the paged serving subset of
``skypilot_tpu/infer/kvcache.py``: the block pool
``[L, n_blocks, block_len, G, hd]``, a per-slot block table mapping
logical block j to a physical block id, wave prefill
(:func:`prefill_batch` + :func:`insert`), chunked prefill
(:func:`claim_slot` + :func:`prefill_chunk`), the prefix cache's
copy-on-write (:func:`copy_block`), the staged decode burst
(:func:`decode_burst_staged`) and the speculative verify round
(:func:`verify_draft_staged`). The chunk's, the burst's and the verify
round's big-cache attention goes through the paged-attention kernel and
merges with the columns they hold outside the cache (the chunk's own
rows, the staged rows).

Two differences from the JAX module, both about mutation:

* JAX donated the cache buffers and got updated copies back; the port
  updates the cache dict's tensors **in place** (``index_put_`` and
  slice assignment) and returns nothing from the writers.
* JAX scatters drop out-of-bounds updates, and the engine relies on it:
  table entries equal to ``n_blocks`` are sentinels, and writes of
  padding rows, dead slots and rows past a slot's allocation route
  there. Torch raises on such an index instead, so the pool holds one
  **trash block** past the ``n_blocks`` the allocator hands out: the
  sentinel id addresses it, sentinel writes land there, and no read
  ever admits its rows (they lie past every slot's length). Table
  columns past the sentinel column clamp to it, as JAX gathers clamp.

Layer loops are Python loops over the stacked ``[L, ...]`` weights where
JAX used ``lax.scan``. Attention runs the CUDA kernels on CUDA tensors
(their plain versions on CPU tensors); ``plain_attention=True`` runs the
plain versions on any device, as the reference the kernels are held to.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.infer import sampling as sampling_mod
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.ops import flash_attention as flash_ops
from skypilot_tpu_torch.ops import paged_attention as paged_attn_ops

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30


def _ffn(cfg: llama.LlamaConfig, h: torch.Tensor, layer: Dict
         ) -> torch.Tensor:
    """Post-norm dense SwiGLU FFN. h: [B, S, D]."""
    return llama.ffn(h, layer, cfg.dtype)


# ---------------------------------------------------------------------------
# Paged block-pool layout
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: llama.LlamaConfig, n_slots: int, n_blocks: int,
                     block_len: int, device: torch.device) -> Cache:
    """Block-pool decode state: ``n_blocks`` physical blocks of
    ``block_len`` rows shared by ``n_slots`` slots, plus the trash
    block (id ``n_blocks``) that sentinel writes land in."""
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (L, n_blocks + 1, block_len, G, hd)
    return {
        "length": torch.zeros((n_slots,), dtype=torch.int32, device=device),
        "last_token": torch.zeros((n_slots,), dtype=torch.long,
                                  device=device),
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


class BlockAllocator:
    """Host-side ref-counted allocator over the paged block pool.

    Pure bookkeeping — no device state. Invariants: a block is FREE xor
    referenced; alloc hands out ref==1 blocks in ascending id order
    (deterministic); incref requires a live block; decref of a free
    block raises (double-free guard); a block is writable only at
    ref==1.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self.reset()

    def reset(self) -> None:
        # Popped from the end: blocks hand out in ascending id order.
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._ref = [0] * self.n_blocks

    @property
    def used(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV block pool exhausted")
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def incref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(f"incref of free block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    def ref(self, block: int) -> int:
        return self._ref[block]

    def writable(self, block: int) -> bool:
        """Safe to scatter into: exactly one owner."""
        return self._ref[block] == 1


@torch.no_grad()
def copy_block(cache: Cache, src: int, dst: int) -> None:
    """Copy-on-write (in place): duplicate physical block ``src``'s rows
    into block ``dst`` in every layer of every cache array. All
    ``block_len`` rows copy; rows past the shared prefix are garbage in
    both blocks and stay unreadable until the new owner overwrites
    them."""
    for name in ("k", "v"):
        cache[name][:, dst] = cache[name][:, src]


def _logical_rows(cache: Cache, table: torch.Tensor) -> int:
    """Rows a slot's attention spans: blocks_per_slot * block_len (the
    table's last column is the sentinel and holds no rows)."""
    return (table.shape[1] - 1) * cache["k"].shape[2]


def _phys(cache: Cache, table: torch.Tensor, slots, idx: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, logical row) -> (physical block, row in block) through the
    block table. Logical rows past the table clamp to its sentinel
    column, whose id addresses the trash block."""
    bl = cache["k"].shape[2]
    col = (idx // bl).clamp(max=table.shape[1] - 1)
    return table[slots, col].long(), idx % bl


def _write_rows(cache: Cache, blk: torch.Tensor, off: torch.Tensor,
                k_rows: torch.Tensor, v_rows: torch.Tensor) -> None:
    """In-place scatter of every layer's rows: ``k_rows``/``v_rows``
    ``[L, *blk.shape, G, hd]`` land at ``[:, blk, off]``."""
    cache["k"][:, blk, off] = k_rows.to(cache["k"].dtype)
    cache["v"][:, blk, off] = v_rows.to(cache["v"].dtype)


def _paged_attn_stats(cache: Cache, i: int, table: torch.Tensor,
                      qh: torch.Tensor, lengths: torch.Tensor,
                      span: Optional[int], plain: bool = False):
    """Big-cache attention stats of layer ``i`` through the paged
    kernel: per (slot, kv-head) it walks the slot's block table over
    ``ceil(span / block_len)`` blocks and masks ``col < lengths``.
    Returns the unnormalized ``(acc, m, l)`` for
    :func:`_merge_attn_parts`."""
    bl = cache["k"].shape[2]
    M = span if span is not None else _logical_rows(cache, table)
    fn = (paged_attn_ops.paged_attention_ref if plain
          else paged_attn_ops.paged_attention)
    return fn(qh, cache["k"], cache["v"], None, None, table, lengths, i,
              span_blocks=-(-M // bl))


def _merge_attn_parts(acc, m, l, ss):
    """Two-block online-softmax combine: fold the staged-columns block
    (masked scores ``ss`` [..., W], masked at -1e30) into the kernel's
    big-cache stats. Returns (alpha, w_s, l_tot); the output is
    ``(acc * alpha + w_s @ v_staged) / l_tot``. A slot with no valid
    cache rows reports m == -1e30 and ``alpha`` underflows to 0."""
    m_tot = torch.maximum(m, ss.amax(dim=-1))
    alpha = torch.exp(m - m_tot)
    w_s = torch.exp(ss - m_tot[..., None])
    l_tot = (l * alpha + w_s.sum(dim=-1)).clamp_min(1e-30)
    return alpha, w_s, l_tot


def _bf16_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 einsum with float32 accumulation (the JAX programs'
    ``preferred_element_type=float32``): inputs round to bf16, then
    multiply in float32, where a product of two bf16 values is exact."""
    return torch.einsum(eq, a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_batch(params: llama.Params, tokens: torch.Tensor,
                  true_lens: torch.Tensor, cfg: llama.LlamaConfig,
                  plain_attention: bool = False
                  ) -> Tuple[Cache, torch.Tensor]:
    """Causal forward over a WAVE of right-padded prompts.

    tokens: [W, S_bucket] int64, true_lens: [W]. Returns ({"k","v"}:
    [L, W, S_bucket, G, hd] post-rope rows, logits at each request's
    last real position [W, vocab] float32). Attention is the flash
    kernel (``ops/attention.py``), or with ``plain_attention`` its
    plain version."""
    attention = None
    if plain_attention:
        def attention(q, k, v):
            return flash_ops.flash_attention_fwd_ref(q, k, v)[0]
    W, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    cos, sin = llama.rope_frequencies(
        cfg, torch.arange(S, device=tokens.device))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = llama.decoder_layer(cfg, x, llama.layer_slice(params, i),
                                      cos, sin, attention)
        ks.append(k)
        vs.append(v)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(W, device=x.device), true_lens.long() - 1]
    return ({"k": torch.stack(ks), "v": torch.stack(vs)},
            llama.logits(last, params, cfg))


@torch.no_grad()
def insert(cache: Cache, prefix: Cache, slot: int, true_len,
           first_token, table: torch.Tensor) -> None:
    """Install a prefilled prompt into decode slot ``slot`` (in place).

    prefix k/v: [L, S_bucket, G, hd]; the rows scatter through the
    slot's block table. Rows >= true_len are padding but harmless —
    decode masks by ``length``; rows past the slot's allocation land
    in the trash block."""
    S = prefix["k"].shape[1]
    blk, off = _phys(cache, table, slot,
                     torch.arange(S, device=prefix["k"].device))
    _write_rows(cache, blk, off, prefix["k"], prefix["v"])
    cache["length"][slot] = true_len
    cache["last_token"][slot] = first_token


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def claim_slot(cache: Cache, slot: int, claim_len: int) -> None:
    """Claim a slot for a cold chunked prefill (in place): its length is
    stamped to ``claim_len`` (max_len), so the rows that interleaved
    decode bursts flush for every slot, active or not, at index
    ``length`` fall past the table and land in the trash block instead
    of over rows a finished chunk already wrote."""
    cache["length"][slot] = claim_len


@torch.no_grad()
def prefill_chunk(params: llama.Params, cache: Cache,
                  tokens_c: torch.Tensor, start: int, n_valid: int,
                  slot: int, new_len: int, cfg: llama.LlamaConfig,
                  sp: sampling_mod.SamplingParams, table: torch.Tensor, *,
                  final: bool, span: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  plain_attention: bool = False) -> torch.Tensor:
    """One chunk of an incremental prefill into decode slot ``slot``.

    tokens_c: [C] right-padded chunk; ``start``: the chunk's first row
    in the slot's sequence (rows below it, earlier chunks, are in the
    cache); ``n_valid``: its real tokens; ``new_len``: the length to
    stamp (max_len mid-prompt, the true total on the final chunk).
    Attention is the big-cache block over the slot's rows below
    ``start`` (the paged kernel with the chunk's ``C * rep`` query rows
    per kv-head, through its block table, ``span``-bounded) merged with
    the causal intra-chunk block, which stays a plain bf16 product as
    the JAX program leaves it to XLA. The chunk's rows then scatter
    through the table (rows past max_len land in the trash block) and
    ``length`` is stamped, in place. Returns the first token sampled
    at the last valid position on the ``final`` chunk, else 0 (device
    tensors)."""
    C = tokens_c.shape[0]
    G, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // G
    scale = hd ** -0.5
    dev = tokens_c.device
    x = params["embed"].to(cfg.dtype)[tokens_c][None]          # [1, C, D]
    cos, sin = llama.rope_frequencies(
        cfg, start + torch.arange(C, device=dev))
    j = torch.arange(C, device=dev)
    # Padding columns (>= n_valid) are masked out of the intra-chunk
    # scores; padding rows compute rows past the prompt's length, which
    # no read admits.
    intra = (j[None, :] <= j[:, None]) & (j[None, :] < n_valid)
    tbl = table[slot:slot + 1]
    lens = torch.full((1,), start, dtype=torch.int32, device=dev)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer = llama.layer_slice(params, i)
        q, k, v = _decode_qkv(cfg, layer, x, cos, sin)
        kr, vr = k[0], v[0]                                    # [C, G, hd]
        ks.append(kr)
        vs.append(vr)
        qh = q[0].reshape(C, G, rep, hd).to(torch.bfloat16)
        ss = _bf16_dot("cgrk,jgk->cgrj", qh, kr) * scale
        ss = ss.masked_fill(~intra[:, None, None, :], NEG_INF)
        # The chunk's C * rep rows of each kv-head in one (slot,
        # kv-head) cell of the kernel, masked below ``start``.
        q_k = qh.permute(1, 0, 2, 3).reshape(1, G, C * rep, hd)
        acc, m, l = _paged_attn_stats(cache, i, tbl, q_k.contiguous(),
                                      lens, span, plain_attention)
        acc = acc.reshape(G, C, rep, hd).permute(1, 0, 2, 3)
        m = m.reshape(G, C, rep).permute(1, 0, 2)
        l = l.reshape(G, C, rep).permute(1, 0, 2)
        alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, ss)
        o = acc * alpha[..., None] + _bf16_dot("cgrj,jgk->cgrk", w_s, vr)
        x = _decode_out_ffn(cfg, layer, x, o / l_tot[..., None])
    if final:
        x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = llama.logits(x[:, n_valid - 1], params, cfg)
        tok = sampling_mod.sample(logits, sp, generator)[0]
    else:
        tok = torch.zeros((), dtype=torch.long, device=dev)
    blk, off = _phys(cache, table, slot, start + j)
    _write_rows(cache, blk, off, torch.stack(ks), torch.stack(vs))
    cache["length"][slot] = new_len
    if final:
        cache["last_token"][slot] = tok
    return tok


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_qkv(cfg, layer, x, cos, sin):
    """Decode-layer front half: norm + q/k/v projections + rope."""
    h = llama.rms_norm(x, layer["ln1"], cfg.norm_eps)
    q = llama.apply_rope(llama.project_in(h, layer["wq"].to(cfg.dtype)),
                         cos, sin)
    k = llama.apply_rope(llama.project_in(h, layer["wk"].to(cfg.dtype)),
                         cos, sin)
    v = llama.project_in(h, layer["wv"].to(cfg.dtype))
    return q, k, v


def _decode_out_ffn(cfg, layer, x, o):
    """Layer back half: output projection + residual + FFN. x: [B, S,
    D]; o: the attention output, B * S rows of every head."""
    o = o.reshape(*x.shape[:2], cfg.n_heads, cfg.head_dim).to(cfg.dtype)
    x = x + llama.project_out(o, layer["wo"].to(cfg.dtype))
    h = llama.rms_norm(x, layer["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, h, layer)


def _decode_head(cfg, params, x):
    """Final norm + LM head: x [B, 1, D] -> logits [B, vocab] float32."""
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return llama.logits(x[:, 0], params, cfg)


def _staged_attn_layer(cfg, cache, table, layer, x, cos, sin, i, s, sk,
                       sv, stage_valid, span, pos0, plain=False):
    """One decoder layer of a staged-burst step: the step's K/V rows
    land in the staging buffers ``sk``/``sv`` [L, B, k, G, hd] (in
    place), attention runs as the big-cache stats of the paged kernel
    (rows below the burst-start lengths ``pos0``, ``span``-bounded)
    merged with the staged-columns dot (columns masked by
    ``stage_valid``), and the big cache stays untouched. The one body
    the burst and the verify round run (:func:`decode_burst_staged`,
    :func:`verify_draft_staged`), as ``kvcache.py:1307-1331`` of the JAX
    package asks of its burst and verify programs, so an accepted verify
    position sees the inputs a plain decode step would. Returns x'."""
    B = x.shape[0]
    G, hd = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // G
    scale = hd ** -0.5
    q, kk, v = _decode_qkv(cfg, layer, x, cos, sin)
    sk[i, :, s] = kk[:, 0].to(sk.dtype)
    sv[i, :, s] = v[:, 0].to(sv.dtype)
    lk, lv = sk[i], sv[i]                              # [B, k, G, hd]
    qh = q[:, 0].reshape(B, G, rep, hd).to(torch.bfloat16).contiguous()
    ss = _bf16_dot("bgrk,bjgk->bgrj", qh, lk) * scale
    ss = ss.masked_fill(~stage_valid[:, None, None, :], NEG_INF)
    acc, m, l = _paged_attn_stats(cache, i, table, qh, pos0, span, plain)
    alpha, w_s, l_tot = _merge_attn_parts(acc, m, l, ss)
    o = acc * alpha[..., None] + _bf16_dot("bgrj,bjgk->bgrk", w_s, lv)
    o = o / l_tot[..., None]
    return _decode_out_ffn(cfg, layer, x, o)


def _flush_staged_rows(cache: Cache, table: torch.Tensor,
                       pos0: torch.Tensor, sk: torch.Tensor,
                       sv: torch.Tensor) -> None:
    """One scatter per cache array: every staged row lands at logical
    [b, pos0[b] + j] through the block table (rows of dead slots or past
    an allocation land in the trash block). The caller updates
    length/last_token."""
    B, W = sk.shape[1], sk.shape[2]
    dev = pos0.device
    idx = pos0.long()[:, None] + torch.arange(W, device=dev)[None, :]
    blk, off = _phys(cache, table,
                     torch.arange(B, device=dev)[:, None], idx)
    _write_rows(cache, blk, off, sk, sv)


@torch.no_grad()
def decode_burst_staged(params: llama.Params, cache: Cache,
                        active: torch.Tensor, k: int,
                        cfg: llama.LlamaConfig,
                        sp: sampling_mod.SamplingParams,
                        table: torch.Tensor, span: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        plain_attention: bool = False) -> torch.Tensor:
    """k decode steps with one cache flush per burst. Returns the
    sampled tokens [k, slots]; the cache is updated in place (rows,
    ``length += k`` on active slots, ``last_token``).

    Within the burst each step's K/V rows land in a small staging
    buffer [L, slots, k, G, hd] and attention runs as big-cache stats
    (rows below the burst-start lengths, a constant mask) merged with
    the staged columns (cols <= step), so the big cache is read-only
    until the flush. Inactive slots compute rows that are never
    committed. ``span``: the big-cache read covers the first ``span``
    logical rows — valid whenever every active slot's burst-start
    length is at most ``span``."""
    B = cache["length"].shape[0]
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dev = cache["k"].device
    kdt = cache["k"].dtype
    pos0 = cache["length"].clone()                     # burst-start rows
    stage_k = torch.zeros((L, B, k, G, hd), dtype=kdt, device=dev)
    stage_v = torch.zeros_like(stage_k)
    last = cache["last_token"].clone()
    embed = params["embed"].to(cfg.dtype)
    layers = [llama.layer_slice(params, i) for i in range(L)]
    toks = []
    for s in range(k):
        x = embed[last][:, None]
        cos, sin = llama.rope_frequencies(cfg, (pos0 + s)[:, None])
        stage_valid = (torch.arange(k, device=dev) <= s)[None, :]
        for i in range(L):
            x = _staged_attn_layer(cfg, cache, table, layers[i], x, cos,
                                   sin, i, s, stage_k, stage_v,
                                   stage_valid, span, pos0,
                                   plain_attention)
        tok = sampling_mod.sample(_decode_head(cfg, params, x), sp,
                                  generator)
        last = torch.where(active, tok, last)
        toks.append(tok)
    _flush_staged_rows(cache, table, pos0, stage_k, stage_v)
    cache["length"] += k * active.to(torch.int32)
    cache["last_token"].copy_(last)
    return torch.stack(toks)


@torch.no_grad()
def verify_draft_staged(params: llama.Params, cache: Cache,
                        draft: torch.Tensor, n_draft: torch.Tensor,
                        active: torch.Tensor, k: int,
                        cfg: llama.LlamaConfig, table: torch.Tensor,
                        span: Optional[int] = None,
                        plain_attention: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify: score ``k`` drafted tokens per slot plus the
    correction position in one call; the cache is updated in place.

    draft: [B, k] proposed tokens; n_draft: [B] real draft tokens per
    slot (the rest pad and never match). The window is ``k + 1``
    positions: position 0 consumes the slot's pending ``last_token``,
    positions 1..k the draft. The K+1 positions scan one after another
    through :func:`_staged_attn_layer`, as a plain burst's steps do
    (big-cache stats below the round-start lengths, merged with the
    staged columns), with the window's tokens in place of sampled
    feedback and greedy argmax outputs.

    Acceptance: out[s] is the argmax after consuming window position
    s; the matched run is the longest prefix over which out[s] ==
    draft[s] at real draft positions, and ``n_commit = n_match + 1`` on
    active slots (the matched draft tokens plus the correction or bonus
    token), 0 on the rest. All K+1 window rows flush at rows
    length..length+k, but ``length`` advances by ``n_commit`` only:
    rejected rows sit past the committed length, unread, until the next
    round overwrites them. ``last_token`` becomes out[n_match].

    Returns (toks [B, k+1], the window's argmax outputs, whose first
    ``n_commit[b]`` of row b are committed; n_commit [B] int32)."""
    B = cache["length"].shape[0]
    W = k + 1
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dev = cache["k"].device
    kdt = cache["k"].dtype
    pos0 = cache["length"].clone()                     # round-start rows
    window = torch.cat([cache["last_token"][:, None], draft.long()], dim=1)
    stage_k = torch.zeros((L, B, W, G, hd), dtype=kdt, device=dev)
    stage_v = torch.zeros_like(stage_k)
    embed = params["embed"].to(cfg.dtype)
    layers = [llama.layer_slice(params, i) for i in range(L)]
    toks = []
    for s in range(W):
        x = embed[window[:, s]][:, None]
        cos, sin = llama.rope_frequencies(cfg, (pos0 + s)[:, None])
        stage_valid = (torch.arange(W, device=dev) <= s)[None, :]
        for i in range(L):
            x = _staged_attn_layer(cfg, cache, table, layers[i], x, cos,
                                   sin, i, s, stage_k, stage_v,
                                   stage_valid, span, pos0,
                                   plain_attention)
        toks.append(sampling_mod.argmax_tokens(
            _decode_head(cfg, params, x)))
    toks = torch.stack(toks, dim=1)                    # [B, W]
    # Padding positions (>= n_draft) never match: a pad that equals the
    # argmax must not commit a token computed from a garbage input.
    match = ((toks[:, :k] == draft.long())
             & (torch.arange(k, device=dev)[None, :]
                < n_draft.long()[:, None]))
    n_match = match.int().cumprod(dim=1).sum(dim=1)
    n_commit = torch.where(active, n_match + 1,
                           torch.zeros_like(n_match)).int()
    _flush_staged_rows(cache, table, pos0, stage_k, stage_v)
    cache["length"] += n_commit
    last = toks[torch.arange(B, device=dev), n_match.long()]
    cache["last_token"].copy_(torch.where(active, last,
                                          cache["last_token"]))
    return toks, n_commit
