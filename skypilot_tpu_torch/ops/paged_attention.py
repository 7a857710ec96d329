"""Paged attention over the block-table KV pool: the CUDA kernel's
bodies, their plain version and their launch counts.

Counterpart of ``skypilot_tpu/ops/paged_attention.py``: the kernel
``csrc/paged_attention.cu`` replaces the Pallas ``_kernel`` driven by
``paged_attention``. For each (slot, kv-head) it returns the
unnormalized online-softmax stats ``(acc, m, l)`` of that slot's ``R``
query rows over logical blocks ``0 .. span_blocks - 1`` of its block
table, for the caller to merge with the columns it holds outside the
cache (``infer/kvcache.py`` ``_merge_attn_parts``): a decode burst's
staged rows, or a prefill chunk's own rows.

:func:`paged_attention` picks the body by shape. The decode body takes
``R * hd <= 4096`` (the GQA rows of a decode step); above that
:func:`paged_attention_rows` takes the ``C * rep`` rows of a prefill
chunk on tensor cores, in one of two multi-row bodies (its docstring
states which runs what): the ``wgmma`` + TMA body for a bfloat16 q on
bfloat16 or int8 pools, the chunk path's dtypes, and the ``mma.sync``
body for float32 pools. Each body counts its own launches. The kernel
source notes each body's design.

What bounds the decode body: the bytes of the K/V rows below each
slot's length. Decode reads every cached row once per step and does
about ``4 R`` operations per element read, far below the card's
operations-per-byte line. The kernel splits each (slot, kv-head) sweep
into chunks of rows, one thread block each (flash decoding), streams
each chunk's K/V tiles through a ring of asynchronous copies once for
all ``R`` rows, so every cached byte crosses device memory once, and
merges a slot's chunks in fixed order inside the same launch; its source
notes the rest of the design. The wrapper hands it a workspace for the
chunks' partial stats and a per-device array of zeroed counters, which
the kernel leaves at zero; calls on one device are expected in one
stream.

Layouts: q ``[B, G, R, hd]`` (float32 or bfloat16); pools
``[L, n_blocks, block_len, G, hd]`` (float32, bfloat16 or int8);
int8 scales ``[L, n_blocks, G, block_len]`` bfloat16; table
``[B, >= span_blocks]`` int32 with sentinel ``n_blocks``; lengths
``[B]`` int32. Returns acc ``[B, G, R, hd]``, m and l ``[B, G, R]``,
all float32. A slot of length 0 reports ``m = -1e30, l = 0, acc = 0``.

:func:`paged_attention` launches the kernel for CUDA tensors (or raises
on what the kernel does not take) and runs the plain version
:func:`paged_attention_ref` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build

NEG_INF = -1e30
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_ROWS_X_HD = 4096     # accumulator registers the decode body holds
_HEAD_DIMS = (32, 64, 128, 256)
_ROWS_HEAD_DIMS = (32, 64, 128)

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gather_kv_layer(pool: torch.Tensor, layer: int, table: torch.Tensor,
                    span: Optional[int] = None) -> torch.Tensor:
    """Layer ``layer`` of a K or V pool arranged per slot in logical row
    order: ``[B, M, G, hd]`` (an int8 scale pool ``[L, n, G, bl]`` gives
    ``[B, G, M]``). Counterpart of ``kvcache._gather_kv_layer``: the
    table's last column is the sentinel and holds no rows; ``span``
    keeps the first ``span`` rows of ``ceil(span / bl)`` whole blocks.
    Sentinel entries clamp to the last block (the rows are masked by
    the caller, as JAX clamps its gathers)."""
    n_blocks = pool.shape[1]
    scales = pool.dim() == 4
    bl = pool.shape[3] if scales else pool.shape[2]
    nb = table.shape[1] - 1
    if span is not None:
        nb = -(-span // bl)
    tbl = table[:, :nb].long().clamp(0, n_blocks - 1)
    B = tbl.shape[0]
    x = pool[layer][tbl]                     # [B, nb, bl, G, hd] | [B, nb, G, bl]
    if scales:
        x = x.permute(0, 2, 1, 3)            # [B, G, nb, bl]
        x = x.reshape(B, x.shape[1], nb * bl)
        return x if span is None else x[..., :span]
    x = x.reshape(B, nb * bl, *x.shape[3:])
    return x if span is None else x[:, :span]


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor,
                        k_scale: Optional[torch.Tensor],
                        v_scale: Optional[torch.Tensor],
                        table: torch.Tensor, lengths: torch.Tensor,
                        layer: int, span_blocks: int) -> Stats:
    """The plain version: gather the slot's blocks, then the kernel's
    arithmetic in float32 over the whole row at once. Columns count only
    below the slot's length and inside a real (non-sentinel) block, so
    a masked column adds exactly 0 to ``l`` and ``acc`` as in the
    kernel."""
    B, G, R, hd = q.shape
    n_blocks, bl = k_pool.shape[1], k_pool.shape[2]
    M = span_blocks * bl
    quant = k_scale is not None
    k = gather_kv_layer(k_pool, layer, table, M).float()     # [B, M, G, hd]
    v = gather_kv_layer(v_pool, layer, table, M).float()
    col = torch.arange(M, device=q.device)
    blk = table[:, :span_blocks].long()
    real = ((blk >= 0) & (blk < n_blocks)).repeat_interleave(bl, dim=1)
    valid = (col[None, :] < lengths[:, None].long()) & real   # [B, M]
    s = torch.einsum("bgrk,bmgk->bgrm", q.float() * hd ** -0.5, k)
    if quant:
        s = s * gather_kv_layer(k_scale, layer, table, M).float()[:, :, None]
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid
    l = p.sum(dim=-1)
    if quant:
        p = p * gather_kv_layer(v_scale, layer, table, M).float()[:, :, None]
    acc = torch.einsum("bgrm,bmgk->bgrk", p, v)
    return acc, m, l


class Int8RowsUnsupportedError(TypeError):
    """An int8 pool reached the multi-row bodies with what neither takes.
    Only the ``wgmma`` body reads int8 pools, and it refuses two cases: a
    float32 q, which the chunk path never sends (it casts q to bfloat16
    first), and a block length other than 8, 16, 32 or a multiple of
    64."""


def _lib() -> ctypes.CDLL:
    """The kernel's library, its launches typed and ``chunk_rows`` (the
    rows of one decode thread block) read once."""
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        rows = lib.paged_attention_rows_launch
        rows.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                         + [ctypes.c_void_p])
        rows.restype = ctypes.c_int
        tc = lib.paged_attention_rows_tc_launch
        tc.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        tc.restype = ctypes.c_int
        lib.chunk_rows = lib.paged_attention_chunk_rows()
    return lib


# Per device: int32 counters, one per (slot, kv-head), that the kernel's
# chunks count off and return to 0; zeroed once, grown as needed.
_tickets: Dict[torch.device, torch.Tensor] = {}


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def _check(q, k_pool, v_pool, k_scale, v_scale, table, lengths, layer,
           span_blocks, rows: bool = False) -> None:
    if q.dim() != 4 or k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_attention: q [B,G,R,hd] and pools "
                         f"[L,n_blocks,bl,G,hd] expected, got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, G, R, hd = q.shape
    L, n_blocks, bl = k_pool.shape[:3]
    if k_pool.shape[3:] != (G, hd):
        raise ValueError("paged_attention: pool heads/head_dim do not "
                         "match q")
    if rows and hd not in _ROWS_HEAD_DIMS:
        raise ValueError(f"paged_attention_rows: hd={hd} (one of "
                         f"{_ROWS_HEAD_DIMS}) not supported by the "
                         f"multi-row body")
    if not rows and (R * hd > _MAX_ROWS_X_HD or hd not in _HEAD_DIMS):
        raise ValueError(f"paged_attention: R*hd={R * hd} (max "
                         f"{_MAX_ROWS_X_HD}) or hd={hd} (one of "
                         f"{_HEAD_DIMS}) not supported by the decode "
                         f"body")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attention: pools must share one of "
                        f"{list(_KV_DTYPES)}, got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    quant = k_pool.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: an int8 pool needs both scale "
                         "tensors, a float pool none")
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.bfloat16 or s.shape != (L, n_blocks, G, bl):
                raise TypeError("paged_attention: scales must be bfloat16 "
                                "[L, n_blocks, G, block_len]")
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[0] != B or table.shape[1] < span_blocks:
        raise TypeError(f"paged_attention: table must be int32 "
                        f"[B, >= span_blocks], got {table.dtype} "
                        f"{tuple(table.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("paged_attention: lengths must be int32 [B]")
    if not 0 <= layer < L:
        raise ValueError(f"paged_attention: layer {layer} outside [0, {L})")
    tensors = [q, k_pool, v_pool, table, lengths]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError("paged_attention: all inputs must be on the "
                             "same CUDA device")
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned "
                         "(the kernel reads rows as 16-byte vectors)")
    if rows and q.data_ptr() % 16:
        raise ValueError("paged_attention_rows: q must be 16-byte aligned "
                         "(the multi-row bodies read it in pairs or by "
                         "TMA)")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                    v_scale: Optional[torch.Tensor], table: torch.Tensor,
                    lengths: torch.Tensor, layer: int, *,
                    span_blocks: int) -> Stats:
    """Block-table-native online-softmax stats ``(acc, m, l)``; see the
    module docstring for layouts. ``R * hd`` above 4096 goes to
    :func:`paged_attention_rows`."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   table, lengths, layer, span_blocks)
    B, G, R, hd = q.shape
    if R * hd > _MAX_ROWS_X_HD:
        return paged_attention_rows(q, k_pool, v_pool, k_scale, v_scale,
                                    table, lengths, layer,
                                    span_blocks=span_blocks)
    _check(q, k_pool, v_pool, k_scale, v_scale, table, lengths, layer,
           span_blocks)
    n_blocks, bl = k_pool.shape[1], k_pool.shape[2]
    dev = q.device
    acc = torch.empty((B, G, R, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, G, R), dtype=torch.float32, device=dev)
    l = torch.empty((B, G, R), dtype=torch.float32, device=dev)
    quant = k_scale is not None
    lib = _lib()
    # One thread block per chunk of rows; with more than one chunk a
    # slot's partial stats meet in the workspace.
    n_chunks = -(-span_blocks * bl // lib.chunk_rows)
    ws = None
    if n_chunks > 1:
        ws = torch.empty(B * G * n_chunks * (R * hd + 2 * R),
                         dtype=torch.float32, device=dev)
    tickets = _ticket_counters(dev, B * G)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(),
            ws.data_ptr() if ws is not None else None, tickets.data_ptr(),
            B, G, R, hd, layer, n_blocks, bl, table.shape[1], span_blocks,
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return acc, m, l


def tma_block_len(block_len: int) -> bool:
    """Whether the ``wgmma`` + TMA multi-row body reads pools of this
    block length: 8, 16, 32 (several blocks a 64-key tile) or a multiple
    of 64 (one)."""
    return block_len % 64 == 0 or block_len in (8, 16, 32)


def _tma_body(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Whether the ``wgmma`` + TMA multi-row body takes these inputs: a
    bfloat16 q on bfloat16 or int8 pools of a block length it reads
    (:func:`tma_block_len`)."""
    return (q.dtype == torch.bfloat16
            and k_pool.dtype in (torch.bfloat16, torch.int8)
            and tma_block_len(k_pool.shape[2]))


def paged_attention_rows(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor,
                         k_scale: Optional[torch.Tensor],
                         v_scale: Optional[torch.Tensor],
                         table: torch.Tensor, lengths: torch.Tensor,
                         layer: int, *, span_blocks: int) -> Stats:
    """:func:`paged_attention` through a multi-row body at any ``R``
    (the chunk path's ``C * rep`` rows), ``hd`` 32, 64 or 128.

    Dispatch: a bfloat16 q on bfloat16 or int8 pools with a block length
    of 8, 16, 32 or a multiple of 64 runs the ``wgmma`` + TMA body
    (counted in ``paged_attention_rows.launches``); every other float
    case (float32 pools, which the engine's float32 parity leg sends, a
    float32 q, or a bfloat16 pool of another block length) runs the
    ``mma.sync`` body (``paged_attention_rows.mma_launches``). The
    dtypes and the block length alone pick the body; a failed build or
    launch raises, and neither body stands in for the other. An int8
    pool that the ``wgmma`` body does not take raises
    :class:`Int8RowsUnsupportedError`."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   table, lengths, layer, span_blocks)
    _check(q, k_pool, v_pool, k_scale, v_scale, table, lengths, layer,
           span_blocks, rows=True)
    tma = _tma_body(q, k_pool)
    if k_pool.dtype == torch.int8 and not tma:
        raise Int8RowsUnsupportedError(
            f"paged_attention_rows: an int8 pool needs a bfloat16 q and a "
            f"block length of 8, 16, 32 or a multiple of 64 (got q "
            f"{q.dtype}, block length {k_pool.shape[2]})")
    B, G, R, hd = q.shape
    dev = q.device
    acc = torch.empty((B, G, R, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, G, R), dtype=torch.float32, device=dev)
    l = torch.empty((B, G, R), dtype=torch.float32, device=dev)
    quant = k_scale is not None
    lib = _lib()
    shape = (B, G, R, hd, layer, k_pool.shape[1], k_pool.shape[2],
             table.shape[1], span_blocks)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tma:
            err = lib.paged_attention_rows_tc_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), *shape,
                _KV_DTYPES[k_pool.dtype], stream)
        else:
            err = lib.paged_attention_rows_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), *shape, _Q_DTYPES[q.dtype],
                _KV_DTYPES[k_pool.dtype], stream)
    _build.check(err, "paged_attention_rows")
    if tma:
        paged_attention_rows.launches += 1
    else:
        paged_attention_rows.mma_launches += 1
    return acc, m, l


# Kernel launches since the count was last set to 0, per body.
paged_attention.launches = 0
paged_attention_rows.launches = 0        # the wgmma + TMA body
paged_attention_rows.mma_launches = 0    # the mma.sync body
