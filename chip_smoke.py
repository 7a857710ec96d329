#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as a release check runs it

Phases, in order; any failure exits nonzero and nothing is swallowed:

1. The card's name and power limit (``nvidia-smi``).
2. Build: every hand-written kernel of ``skypilot_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``, one process per source, all at once; ptxas's
   registers and spills per kernel function.
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs at its main path's shapes (K1/K2 serving, K3/K4 the
   llama3-1b training shape), with its time (CUDA events over many
   launches), its bound (the larger of bytes over the memory rate and
   operations over the peak rate), the plain version's time and, where
   one PyTorch call computes the same function, that call's time; each
   line adds the achieved TFLOP/s, the share of the bound reached and
   the time over the library call's. The flash kernels' bf16 outputs
   are held per element to one bf16 ulp of the plain value plus 1e-3 of
   its largest magnitude, their float32 outputs and the logsumexp to
   1e-4 of it; K1's partial sums to 2e-3 of it, its length-0 slots
   exactly. K1 (which merges a slot's chunks inside its own launch) and
   the bf16 K3/K4 must give equal bits on a second call. K1 also runs a
   long-context case after the main path's (16 slots of 3000-4096 rows)
   and an int8 case at the int8 serve leg's shape (32 slots of int8
   pools, spans to 1280).
   K1's multi-row bodies (``paged_attention_rows``): the ``wgmma`` one
   runs at the serve chunk's shape (2048 query rows of a kv-head over
   the 512 rows below the chunk), at a chunk's start of 0, at two
   chunks of an 8192-token prompt (starts 3584 and 7680, on pools of 4
   layers whose K/V, cycled over the layers, exceeds the 50 MB L2) and
   at the serve chunk on int8 pools; the ``mma.sync`` one at the serve chunk
   on float32 pools; each case must run its own body only. SDPA over
   the same K/V, gathered, is printed beside each as a
   yardstick (no PyTorch call returns the unnormalized stats). A K1
   call takes less device time than its wrapper takes on the host, so
   its time comes from replaying 64 launches from a CUDA graph; the
   eager loop's time and the host's time per call are printed beside
   it.
4. Serve: the port's HTTP server (``infer/server.py``) at llama3-8b
   full width and depth with random bf16 weights from a fixed seed, in
   the reference server's default configuration (chunks of 512, a
   prefix pool of 8, n-gram speculation at K = 4), answers 9 concurrent
   ``/generate`` requests, two of them streamed twins of a chunked and
   of a wave prompt; prompts longer than 512 tokens go through chunked
   prefill. The kernels' launch counts and the engine's drafted,
   accepted and verify counts are set to 0 just before and read just
   after (at least one verify round must run; the ``wgmma`` multi-row
   body must launch once a layer per chunk not skipped by a prefix hit
   and the ``mma.sync`` one never, and trailers report the chunks).
   Then a shared-prefix pair (820 and 760 tokens sharing 600), one
   after the other: the first reports no hit and 2 chunks, the second
   a 512-token hit and 1 chunk (32 multi-row launches from start 512
   over the first's blocks); the second again after
   ``clear_prefix_cache()`` is its cold rerun (TTFT and any bf16
   divergence reported). One 512-token chunk of a
   long prompt at starts 3584 and 7680 of a one-slot cache of max_len
   8192 is timed (wall, and from one profiled chunk the device time of
   the multi-row body, of matmul and of the rest); two
   prompts (one chunked) are replayed through
   an engine that runs the plain attention versions on the same card
   beside one that runs the kernels, in bf16 (divergence reported) and
   on the same weights in float32, where greedy tokens must agree
   wherever the plain logits' top-2 gap exceeds 1e-2. The float32 leg
   reads float32 pools, so its chunks run the ``mma.sync`` multi-row
   body: counts set to 0 before that leg and read after it, that body
   must launch once a layer per chunk and the ``wgmma`` one never. On
   the same float32 weights, kernel path: spec K 4 with an oracle
   drafter (every position accepts) and with an anti-oracle (none
   does) must give the spec-off tokens, and the prefix pair's warm
   request its cold rerun's, under the same 1e-2 rule. Two float32 int8
   legs repeat the kernel-against-plain, spec and prefix checks over int8
   KV pools on the first 8 of the 32 layers (their chunks run the
   ``wgmma`` body on int8 pools, counted from 0): on the float32
   weights, under the 1e-2 rule, and on the same weights quantized once
   (w8a8), where the bound is the larger of 1e-2 and the plain logits'
   own shift on that context when the embedding moves by two float32
   ulps (w8a8 rounds activations to int8, so float32-sized noise moves
   its logits by ~0.2). The int8 leg (``serve[int8]``) then serves the
   reference's int8 recipe, ``llm/serve-8b-w8a8.yaml`` (32 slots,
   max_len 1280,
   ``--kv-int8 --weights-int8``, max burst 32, waves of 4), at llama3-8b
   full width and depth: int8 pools with bf16 scales, only the slim
   float tree resident (``memory_allocated`` held to the slim weights,
   the int8 weights and the int8 KV), the same 9 requests and prefix
   pair under the same checks, TTFT and decode rate beside the bf16
   leg's, one profiled decode burst over all 32 slots split into
   ``torch._int_mm``, the quantizers, K1 and the rest, and
   ``torch._int_mm`` timed at the recipe's shapes with the weight
   column-major (as stored) and row-major.
5. Handoff: the cross-replica KV handoff of disaggregated serving
   between two HTTP servers on the card, a prefill tier P and a decode
   tier D on one params tree: llama3-8b bf16 at full depth in the serve
   phase's settings, the int8 recipe at full depth (32 slots, max_len
   1280, quantized once) and float32 on the first 8 layers. The single
   tier first (prompts of 775 and 597 tokens, 32 new tokens, on D's
   ``/generate``), then, launch counts set to 0, each prompt's
   ``/prefill`` on P and its ``/handoff`` on D, blocking and streamed,
   D's prefix cache cleared before each: every handoff imports the
   512-row prefix and resumes over it (``resumed_len`` 512, one prefix
   hit), the tokens agree with the single tier's under the serve
   phase's rules, a 491-token prompt gets the typed 409, each tier
   holds only its resident entries' blocks, K1's decode body and the
   multi-row body the pools pick launch (``wgmma`` on bf16 and int8,
   ``mma.sync`` on float32, never the other), K1 is held against its
   plain version at every shape of the leg and, with the trash block
   filled with 100.0, on D's imported blocks. Export, encode, wire,
   decode and import times, ``/prefill`` wall and the time to the
   first streamed decode token are printed beside the single tier's
   TTFT and decode rate.
6. Bench: the port's serving bench (``infer/bench_serve.py``) at
   llama3-8b full width and depth, bf16, random weights from seed 0,
   through its own functions, launch counts set to 0 before each leg
   and read after it: ``run_http`` (8 streamed requests of mixed
   512-1024-token prompts over HTTP, 32 new tokens, three timed waves
   after a warmup wave; every response 200 with 32 tokens, finite
   positive TTFT, p99 TTFT, tokens/s and TPOT), ``run`` (16 requests of
   96 tokens on the engine alone, 64 tokens each) and
   ``run_prefix_share`` at its full-size defaults (a 768-token system
   prompt, 48-token tails, chunks of 256, 12 requests: no cold hit,
   every warm request a hit of one suffix chunk, fewer chunks than
   cold, interference bursts run; where warm and cold tokens part,
   each divergence is held to the serve phase's 1e-2 top-2 gap rule,
   the gap read from the plain path on the weights in float32 and the
   floor raised to the bf16 noise on that context). The bench keeps
   the reference's max_len, so on the card its KV blocks are 8 rows
   (the engine's choice for K1). Each leg prints its report line; K1's
   decode and ``wgmma`` multi-row bodies and K2 must launch, the
   ``mma.sync`` body never; after each leg, K1 and K2 are held against
   their plain versions at every shape the leg gave them (random
   inputs, the leg's tables, lengths and spans). The kernels phase
   times K1 and K2 at the bench's main shapes.
7. Train: gradient parity of the kernels against the plain versions at
   llama3-1b width (2 layers, fp32 asserted, bf16 reported); then
   ``train.run`` at llama3-1b full width and depth for 6 steps on a
   repeated batch (counts set to 0 before, read after: K2 32, K3 16 and
   K4 16 launches a step; the loss must fall), one profiled step, and a
   llama3-tiny resume from a checkpoint that must equal the
   uninterrupted run bit for bit.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--phase kernels``, ``serve``,
``handoff``, ``bench`` or ``train`` runs one of phases 3-7 alone (the
build always runs).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# NVIDIA H100 SXM data sheet: HBM3 rate and dense peak rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
SEED = 0


def _log(*a) -> None:
    print(*a, flush=True)


def _bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _rates(ms: float, n_ops: float, bound_ms: float, library_ms) -> dict:
    """What a kernel's time means: its achieved rate, the share of the
    card's bound it reaches and its time over the library call's."""
    return {"tflops": n_ops / (ms * 1e-3) / 1e12,
            "bound_share": bound_ms / ms,
            "vs_library": None if library_ms is None else ms / library_ms}


def _rates_text(r: dict) -> str:
    lib = ("n/a" if r["vs_library"] is None
           else f"{r['vs_library']:.2f}x library")
    return (f"{r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.1f}% of "
            f"bound, {lib}")


def _ptxas_summary(log: str):
    """Each warning line of an ``nvcc -Xptxas -v`` log (C7514/C7515 say
    a ``wgmma`` was serialized), then one line per kernel function: its
    (demangled) name, registers and spill bytes."""
    import re
    import shutil
    funcs = []  # [mangled name, registers, spill stores, spill loads]
    for line in log.splitlines():
        if "warning" in line.lower():
            yield line.strip()
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            funcs.append([m.group(1), "?", "0", "0"])
        elif funcs and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            funcs[-1][2:] = m.groups()
        elif funcs and (m := re.search(r"Used (\d+) registers", line)):
            funcs[-1][1] = m.group(1)
    names = [f[0] for f in funcs]
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    for name, (_, regs, st, ld) in zip(names, funcs):
        for old, new in (("(anonymous namespace)::", ""),
                         ("<unnamed>::", ""), ("(int)", ""), ("void ", ""),
                         ("(bool)1", "true"), ("(bool)0", "false"),
                         ("__nv_bfloat16", "bf16")):
            name = name.replace(old, new)
        yield (f"{name.split('(')[0]}: {regs} registers, spill stores "
               f"{st} B, loads {ld} B")


def _time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``n`` calls, by CUDA events."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms(fn, n: int) -> float:
    """Mean device time of ``fn(i)`` over ``n`` calls replayed from one
    CUDA graph, by CUDA events: the launches run back to back, without
    the host's time per call between them (which, for a kernel shorter
    than its Python wrapper's call, is what ``_time_ms`` would time)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def _host_ms(fn, n: int) -> float:
    """Mean host time of one ``fn(i)`` call (its enqueue, not its run)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def _err(got, want, name: str, rel: float):
    """Max |got - want| and the check against rel * max|want|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not err <= rel * max(scale, 1e-30):
        raise AssertionError(f"{name}: max|kernel - plain| = {err:.3e} "
                             f"exceeds {rel} * max|plain| = "
                             f"{rel * scale:.3e}")
    return err


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _paged_case(quant: bool, gen, dev):
    """K1 inputs at the decode burst's shapes: 16 slots, 8 kv-heads, 4
    query rows each (the GQA repeat), head_dim 128, 256-row blocks in a
    pool of 65, a 32-layer pool read at layer 5, table of 4 + sentinel
    columns swept to span 768 (3 blocks). Lengths: 0, partial final
    blocks, full, and past the span; block ids scattered."""
    import torch
    L, n_blocks, bl, G, hd = 32, 65, 256, 8, 128
    B, R, nb, span_blocks, layer = 16, 4, 4, 3, 5
    shape = (L, n_blocks, bl, G, hd)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        sshape = (L, n_blocks, G, bl)
        ks = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              + 1e-3).to(torch.bfloat16)
        vs = (torch.rand(sshape, generator=gen, device=dev) * 0.02
              + 1e-3).to(torch.bfloat16)
    else:
        kp = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        ks = vs = None
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = [0, 1, 255, 256, 257, 600, 767, 768, 1000, 1024,
               130, 511, 512, 700, 2, 900]
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    table = torch.full((B, nb + 1), n_blocks, dtype=torch.int32)
    for b, n in enumerate(lengths):
        have = -(-n // bl)
        table[b, :have] = torch.tensor(perm[b * nb: b * nb + have])
    table = table.to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                table=table, lengths=lens, layer=layer,
                span_blocks=span_blocks)


def _paged_long_case(gen, dev):
    """K1 at long context: 16 slots of 3000-4096 rows, 8 kv-heads, 4
    query rows, head_dim 128, bf16, swept to span 16 blocks of 256 (the
    kernel's chunks: 24-32 a slot) in a 4-layer pool."""
    import torch
    L, bl, G, hd, B, R, nb = 4, 256, 8, 128, 16, 4, 16
    n_blocks = B * nb + 1
    shape = (L, n_blocks, bl, G, hd)
    kp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.randint(3000, 4097, (B,), generator=gen, device=dev)
    perm = torch.randperm(n_blocks, generator=gen, device=dev)
    table = torch.full((B, nb + 1), n_blocks, dtype=torch.int32, device=dev)
    table[:, :nb] = perm[:B * nb].reshape(B, nb).int()
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lengths.int(), layer=2, span_blocks=nb)


def _paged_int8_serve_case(gen, dev):
    """K1's decode body at the int8 serve leg's shapes (``--slots 32
    --max-len 1280 --kv-int8``): 32 slots of llama3-8b (8 kv-heads, 4
    query rows, head_dim 128) over int8 pools with bf16 scales, blocks of
    256 (5 a slot: 160 and the trash block), 32 layers read at layer 5,
    lengths from 0 to 1280 swept at the full span."""
    import torch
    L, bl, G, hd, B, R, nb = 32, 256, 8, 128, 32, 4, 5
    n_blocks = B * nb + 1
    kp, vp, ks, vs = _rows_pools((L, n_blocks, bl, G, hd), "int8", gen,
                                  dev)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.randint(1, nb * bl + 1, (B,), generator=gen, device=dev)
    lengths[0], lengths[1] = 0, nb * bl
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((B, nb + 1), n_blocks - 1, dtype=torch.int32,
                       device=dev)
    table[:, :nb] = perm[:B * nb].reshape(B, nb).int()
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                table=table, lengths=lengths.int(), layer=5, span_blocks=nb)


def _paged_rows_case(start: int, gen, dev, kv: str = "bf16"):
    """K1's multi-row body at the chunk program's shapes on the serve
    path (llama3-8b, chunk 512, max_len 1024): one slot, 8 kv-heads,
    512 x 4 = 2048 query rows each, head_dim 128, bf16 q; the slot's
    length is the chunk's ``start``, the span rung covering it is 512
    rows (2 blocks of 256), the pool is the serve cache's (32 layers,
    64 blocks and the trash block), read at layer 5. ``kv``: the pools'
    dtype, ``bf16``, ``int8`` (with bf16 scales, as the int8 KV cache
    stores them) or ``f32`` (the engine's float32 parity leg)."""
    import torch
    L, n_blocks, bl, G, hd = 32, 65, 256, 8, 128
    kp, vp, ks, vs = _rows_pools((L, n_blocks, bl, G, hd), kv, gen, dev)
    q = torch.randn((1, G, 512 * 4, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((1, 5), n_blocks - 1, dtype=torch.int32, device=dev)
    table[0, :3] = perm[:3].int()          # 775 tokens' blocks
    lens = torch.tensor([start], dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                table=table, lengths=lens, layer=5, span_blocks=2)


def _paged_bench_case(gen, dev):
    """K1's decode body at bench[http]'s shapes (llama3-8b, 16 slots,
    max_len 1064 = 1024 + 32 + 8): bf16 pools in blocks of 8, the one
    block length that tiles 1064 and that K1's multi-row body reads
    (``engine.kv_block_len``), 133 a slot and the trash block, 32
    layers read at layer 5, table columns scattered, lengths 512-1064
    with one empty and one full slot, swept at the full span."""
    import torch
    L, bl, G, hd, B, R, nb = 32, 8, 8, 128, 16, 4, 133
    n_blocks = B * nb + 1
    kp, vp, _, _ = _rows_pools((L, n_blocks, bl, G, hd), "bf16", gen, dev)
    q = torch.randn((B, G, R, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    lengths = torch.randint(512, nb * bl + 1, (B,), generator=gen,
                            device=dev)
    lengths[0], lengths[1] = 0, nb * bl
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((B, nb + 1), n_blocks - 1, dtype=torch.int32,
                       device=dev)
    table[:, :nb] = perm.reshape(B, nb).int()
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lengths.int(), layer=5, span_blocks=nb)


def _paged_rows_bench_case(start: int, gen, dev):
    """K1's multi-row body at bench[prefix]'s chunk shapes (llama3-8b,
    chunks of 256 tokens: 1024 query rows a kv-head; max_len 872 = 768 +
    48 + 48 + 8, so blocks of 8, 109 a slot): one slot of a 16-slot
    pool (32 layers, read at layer 5) whose length is the chunk's
    ``start``, swept to the engine's span rung covering it (the ladder
    109, 218, 436, 872 rows: 436 for 256, which is 54.5 blocks and so
    ends inside a block; all 872 for 768)."""
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    L, bl, G, hd, nb = 32, 8, 8, 128, 109
    n_blocks = 16 * nb + 1
    kp, vp, _, _ = _rows_pools((L, n_blocks, bl, G, hd), "bf16", gen, dev)
    q = torch.randn((1, G, 256 * 4, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev)
    table = torch.full((1, nb + 1), n_blocks - 1, dtype=torch.int32,
                       device=dev)
    table[0, :nb] = perm[:nb].int()
    span = next(r for r in eng._span_ladder(None, nb * bl) if start <= r)
    lens = torch.tensor([start], dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lens, layer=5,
                span_blocks=-(-span // bl))


def _rows_pools(shape, kv: str, gen, dev):
    """K and V pools of ``shape`` (bf16 or f32, or int8 with bf16 scales
    ``[L, n_blocks, G, bl]``) and their scales (None but for int8)."""
    import torch
    if kv != "int8":
        dtype = torch.bfloat16 if kv == "bf16" else torch.float32
        return (torch.randn(shape, generator=gen, device=dev, dtype=dtype),
                torch.randn(shape, generator=gen, device=dev, dtype=dtype),
                None, None)
    L, n, bl, G, _ = shape
    pools = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [(torch.rand((L, n, G, bl), generator=gen, device=dev) * 0.02
               + 1e-3).to(torch.bfloat16) for _ in range(2)]
    return pools[0], pools[1], scales[0], scales[1]


def _paged_rows_long_case(start: int, gen, dev):
    """The multi-row body on a long prompt's chunk: llama3-8b at max_len
    8192 (``models/llama.py``'s longest context), one slot, 8 kv-heads,
    2048 query rows each, head_dim 128, bf16; the slot's length is the
    chunk's ``start`` and the span the engine's rung covering it (4096
    rows for 3584, the full 8192 for 7680), blocks of 256. The pool
    holds 4 layers (the body reads one; 4 put the launches' combined
    K/V past the 50 MB L2, as the 32 layers of a chunk do) of the span's
    blocks and the trash block, read at layer 1."""
    import torch
    G, hd, bl = 8, 128, 256
    nb = 16 if start < 4096 else 32
    n_blocks = nb + 1
    kp, vp, _, _ = _rows_pools((4, n_blocks, bl, G, hd), "bf16", gen,
                                dev)
    q = torch.randn((1, G, 512 * 4, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    table = torch.full((1, nb + 1), nb, dtype=torch.int32, device=dev)
    table[0, :nb] = torch.randperm(nb, generator=gen, device=dev).int()
    lens = torch.tensor([start], dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=kp, v_pool=vp, k_scale=None, v_scale=None,
                table=table, lengths=lens, layer=1, span_blocks=nb)


def _sdpa_yardstick(name: str, case) -> None:
    """SDPA on the rows case's q over the slot's K/V rows below its
    length, gathered beforehand (int8 rows cast to bf16, scales left
    out): a library yardstick line only, since no PyTorch call returns
    the unnormalized stats."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import paged_attention as pa
    n = int(case["lengths"][0])
    q = case["q"]
    k = pa.gather_kv_layer(case["k_pool"], case["layer"], case["table"],
                           n).transpose(1, 2).to(q.dtype).contiguous()
    v = pa.gather_kv_layer(case["v_pool"], case["layer"], case["table"],
                           n).transpose(1, 2).to(q.dtype).contiguous()
    ms = _time_ms(lambda i: F.scaled_dot_product_attention(q, k, v), 20)
    _log(f"kernel {name}: yardstick, not a library equivalent: SDPA of "
         f"the same q over the {n} rows gathered ({tuple(k.shape)}) "
         f"{ms:.4f} ms")


def _paged_err(name: str, case, fn) -> float:
    """The largest error of K1 through ``fn`` against the plain version
    on ``case``, held to 2e-3 of each output's largest magnitude; a
    second call must give the same bits and a length-0 slot the empty
    stats."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    args = (case["q"], case["k_pool"], case["v_pool"], case["k_scale"],
            case["v_scale"], case["table"], case["lengths"])
    lay, sb = case["layer"], case["span_blocks"]
    acc, m, l = fn(*args, lay, span_blocks=sb)
    again = fn(*args, lay, span_blocks=sb)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((acc, m, l), again)):
        raise AssertionError(f"{name}: a second call gave other bits")
    del again
    racc, rm, rl = pa.paged_attention_ref(*args, lay, sb)
    empty = case["lengths"] == 0
    if not (torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0)
            and torch.all(acc[empty] == 0)):
        raise AssertionError(f"{name}: a length-0 slot must report "
                             f"m=-1e30, l=0, acc=0")
    live = ~empty
    rel = 2e-3
    err = 0.0
    if live.any():
        err = max(_err(acc[live], racc[live], f"{name} acc", rel),
                  _err(m[live], rm[live], f"{name} m", rel),
                  _err(l[live], rl[live], f"{name} l", rel))
    return err


def _check_paged(name: str, case, fn=None) -> dict:
    from skypilot_tpu_torch.ops import paged_attention as pa
    fn = fn or pa.paged_attention
    err = _paged_err(name, case, fn)
    args = (case["q"], case["k_pool"], case["v_pool"], case["k_scale"],
            case["v_scale"], case["table"], case["lengths"])
    sb = case["span_blocks"]
    live = case["lengths"] != 0
    L = case["k_pool"].shape[0]

    # Cycle the layer so each launch reads blocks no earlier launch left
    # in L2, as the loops over layers do.
    def kern(i):
        fn(*args, i % L, span_blocks=sb)

    def plain(i):
        pa.paged_attention_ref(*args, i % L, sb)

    # A call is shorter than the wrapper's host time, so the kernel's own
    # time comes from graph replay; the eager loop and the host's time a
    # call are reported beside it.
    ms = _graph_ms(kern, 64)
    eager_ms = _time_ms(kern, 64)
    host_ms = _host_ms(kern, 64)
    plain_ms = _time_ms(plain, 8)
    B, G, R, hd = case["q"].shape
    bl = case["k_pool"].shape[2]
    # The K/V rows (and scales) below each slot's length within the
    # span, and the q rows of the slots that have any: what this run's
    # data needs read.
    rows = case["lengths"].clamp(max=sb * bl).long().sum().item()
    kv_item = case["k_pool"].element_size()
    n_bytes = (live.sum().item() * G * R * hd * case["q"].element_size()
               + 2 * rows * G * hd * kv_item
               + (2 * rows * G * 2 if case["k_scale"] is not None
                  else 0)
               + case["table"].numel() * 4 + B * 4
               + (B * G * R * hd + 2 * B * G * R) * 4)
    n_ops = 4 * rows * G * R * hd
    # The wgmma multi-row body multiplies in bf16 on bf16 and int8 pools
    # (int8 rows are widened to bf16); the decode body reads int8 as
    # int8; float32 pools are bounded at the float32 peak, as the
    # float32 flash rows are.
    kind = ("fp32" if kv_item == 4
            else "int8" if kv_item == 1 and fn is pa.paged_attention
            else "bf16")
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, kind)
    rates = _rates(ms, n_ops, bound_ms, None)
    _log(f"kernel {name}: max_abs_err={err:.3e} ms={ms:.4f} (graph "
         f"replay; eager loop {eager_ms:.4f}, host {host_ms:.4f} a call) "
         f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}); "
         + _rates_text(rates))
    return dict(name=name, max_abs_err=err, ms=ms, eager_ms=eager_ms,
                host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, **rates)


def _flash_case(S: int, segments: bool, gen, dev, B: int = 8):
    """K2 inputs at the wave prefill's shapes: a wave of ``B`` prompts,
    32 q-heads over 8 kv-heads, head_dim 128, bf16."""
    import torch
    H, Hkv, D = 32, 8, 128
    q = torch.randn((B, S, H, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    seg = None
    if segments:
        # Packed documents: segment id steps at random cut points.
        cuts = torch.rand((B, S), generator=gen, device=dev) < 4.0 / S
        seg = cuts.int().cumsum(dim=1).to(torch.int32)
    return dict(q=q, k=k, v=v, seg=seg)


def _flash_err(name: str, case):
    """K2 against the plain version on ``case``: (largest error, O,
    lse)."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v, seg = case["q"], case["k"], case["v"], case["seg"]
    causal = case.get("causal", True)
    o, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_ref(q, k, v, seg, causal=causal)
    # O is bf16 (P is rounded to bf16 before P V, as the plain version's
    # fp32 P is not): the bf16-ulp rule of K3/K4. lse is float32 on both
    # sides and differs only in the order of fp32 sums.
    err = max(_bf16_ulp_err(o, ro, f"{name} O"),
              _err(lse, rlse, f"{name} lse", 1e-4))
    return err, o, lse


def _check_flash(name: str, case) -> dict:
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v, seg = case["q"], case["k"], case["v"], case["seg"]
    err, o, lse = _flash_err(name, case)
    B, S, H, D = q.shape
    ms = _time_ms(lambda i: fa.flash_attention_fwd(q, k, v, seg), 5)
    plain_ms = _time_ms(
        lambda i: fa.flash_attention_fwd_ref(q, k, v, seg), 2, warmup=1)
    # The library yardstick: one scaled_dot_product_attention call on
    # the same tensors ([B, H, S, D] views, GQA unexpanded).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        mask = same & causal
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        pairs = mask.sum().item() * H
    else:
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        pairs = B * H * S * (S + 1) // 2
    library_ms = _time_ms(lib, 5)
    item = q.element_size()
    n_bytes = ((q.numel() + k.numel() + v.numel() + o.numel()) * item
               + lse.numel() * 4 + (seg.numel() * 4 if seg is not None
                                    else 0))
    n_ops = 4 * pairs * D
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, "bf16")
    rates = _rates(ms, n_ops, bound_ms, library_ms)
    _log(f"kernel {name}: max_abs_err={err:.3e} ms={ms:.4f} "
         f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
         f"library_ms={library_ms:.4f}; " + _rates_text(rates))
    return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **rates)


def _bf16_ulp_err(got, want, name: str, floor_rel: float = 1e-3):
    """Max |got - want| for bf16 outputs, held per element to one bf16
    ulp of the plain value plus ``floor_rel`` * max|plain| (a flipped
    rounding costs one ulp; near zero, where fp32 summation order
    dominates, the floor applies)."""
    import torch
    w = want.float()
    d = (got.float() - w).abs()
    # ulp of a bf16 value x: 2^(floor(log2|x|) - 7); frexp gives
    # |x| = m 2^e with m in [0.5, 1), so floor(log2|x|) = e - 1.
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    tol = ulp + floor_rel * w.abs().max()
    worst = (d / tol).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds one bf16 "
                             f"ulp + {floor_rel} * max|plain| "
                             f"(worst ratio {worst:.3f})")
    return d.max().item()


def _bwd_case(dtype, segments: bool, gen, dev):
    """K3/K4 inputs at llama3-1b's training shape: batch 4, S 2048, 16
    q-heads over 8 kv-heads, head_dim 128, causal; O and lse from the
    forward kernel, dO random."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    B, S, H, Hkv, D = 4, 2048, 16, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    do = randn(B, S, H, D)
    seg = None
    if segments:
        cuts = torch.rand((B, S), generator=gen, device=dev) < 4.0 / S
        seg = cuts.int().cumsum(dim=1).to(torch.int32)
    o, lse = fa.flash_attention_fwd(q, k, v, seg)
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, seg=seg,
                delta=fa.attention_delta(o, do))


def _check_bwd(name: str, case) -> dict:
    """K3 and K4 against the plain backward on the same inputs; each
    kernel's time, bound and plain time, and the library yardstick:
    the backward of one scaled_dot_product_attention call, which
    computes dQ, dK and dV together (on both rows)."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v, o, lse, do, seg, delta = (case[n] for n in (
        "q", "k", "v", "o", "lse", "do", "seg", "delta"))
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg)
    torch.cuda.synchronize()
    if q.dtype == torch.bfloat16:
        # No atomics: a second call gives the same bits.
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, seg)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg)
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"{name}: K3/K4 gave other bits on a "
                                 f"second call")
        del dq2, dk2, dv2
    rq, rk, rv = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, seg)
    if q.dtype == torch.bfloat16:
        err_dkv = max(_bf16_ulp_err(dk, rk, f"{name} dK"),
                      _bf16_ulp_err(dv, rv, f"{name} dV"))
        err_dq = _bf16_ulp_err(dq, rq, f"{name} dQ")
        kind = "bf16"
    else:
        err_dkv = max(_err(dk, rk, f"{name} dK", 1e-4),
                      _err(dv, rv, f"{name} dV", 1e-4))
        err_dq = _err(dq, rq, f"{name} dQ", 1e-4)
        kind = "fp32"
    del rq, rk, rv
    ms_dkv = _time_ms(lambda i: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, seg), 5)
    ms_dq = _time_ms(lambda i: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, seg), 5)
    plain_ms = _time_ms(lambda i: fa.flash_attention_bwd_ref(
        q, k, v, o, lse, do, seg), 2, warmup=1)
    B, S, H, D = q.shape
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if seg is not None:
        mask = (seg[:, None, :, None] == seg[:, None, None, :]) & causal
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                             enable_gqa=True)
        pairs = mask.sum().item() * H
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        pairs = B * H * S * (S + 1) // 2
    dot = do.transpose(1, 2)
    library_ms = _time_ms(lambda i: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 5)
    del out
    item = q.element_size()
    # Each input read once, each output written once.
    n_in = ((q.numel() + k.numel() + v.numel() + do.numel()) * item
            + (lse.numel() + delta.numel()) * 4
            + (seg.numel() * 4 if seg is not None else 0))
    rows = []
    for kname, ms, err, n_out, ops_per_pair in (
            ("flash_attention_bwd_dkv", ms_dkv, err_dkv,
             (k.numel() + v.numel()) * item, 8),
            ("flash_attention_bwd_dq", ms_dq, err_dq, q.numel() * item, 6)):
        n_ops = ops_per_pair * pairs * D
        bound_ms, bound_by = _bound_ms(n_in + n_out, n_ops, kind)
        rates = _rates(ms, n_ops, bound_ms, library_ms)
        _log(f"kernel {kname}{name}: max_abs_err={err:.3e} ms={ms:.4f} "
             f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
             f"({bound_by}) library_ms={library_ms:.4f}; "
             + _rates_text(rates))
        rows.append((kname, dict(name=kname + name, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms,
                                 **rates)))
    return dict(rows)


def _rows_cases(gen, dev):
    """K1's multi-row bodies, each against the plain version, with its
    SDPA yardstick where the slot holds rows. The wgmma body: the serve
    chunk (start 512), an empty slot (start 0), two chunks of a long
    prompt (starts 3584 and 7680), the serve chunk on int8 pools and
    two of bench[prefix]'s 256-token chunks on blocks of 8 (starts 256
    and 768). The mma.sync body: the serve chunk on float32 pools (bf16 q, as the
    engine's float32 parity leg sends it). Returns (wgmma cases,
    mma.sync cases); each case must move its own body's count only."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    fn = pa.paged_attention_rows
    out = {"paged_attention_rows": [], "paged_attention_rows_mma": []}
    for kname, label, make, start in (
            ("paged_attention_rows", "bf16,start=512", _paged_rows_case, 512),
            ("paged_attention_rows", "bf16,start=0", _paged_rows_case, 0),
            ("paged_attention_rows", "bf16,start=3584",
             _paged_rows_long_case, 3584),
            ("paged_attention_rows", "bf16,start=7680",
             _paged_rows_long_case, 7680),
            ("paged_attention_rows", "int8,start=512",
             functools.partial(_paged_rows_case, kv="int8"), 512),
            ("paged_attention_rows", "bf16,blocks of 8,R=1024,start=256",
             _paged_rows_bench_case, 256),
            ("paged_attention_rows", "bf16,blocks of 8,R=1024,start=768",
             _paged_rows_bench_case, 768),
            ("paged_attention_rows_mma", "f32,start=512",
             functools.partial(_paged_rows_case, kv="f32"), 512)):
        case = make(start, gen, dev)
        name = f"{kname}[{label}]"
        before = (fn.launches, fn.mma_launches)
        out[kname].append(_check_paged(name, case, fn))
        moved = (fn.launches - before[0], fn.mma_launches - before[1])
        mma = kname == "paged_attention_rows_mma"
        if not moved[int(mma)] or moved[int(not mma)]:
            raise AssertionError(f"{name}: launches (wgmma, mma.sync) "
                                 f"{moved}; only the "
                                 f"{'mma.sync' if mma else 'wgmma'} body "
                                 f"should have run")
        if int(case["lengths"][0]):
            _sdpa_yardstick(name, case)
        del case
        torch.cuda.empty_cache()
    return out


def phase_kernels(dev):
    """Returns {kernel: [case results]}, the main-path case first."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    paged = [_check_paged("paged_attention[bf16]",
                          _paged_case(False, gen, dev)),
             _check_paged("paged_attention[int8]",
                          _paged_case(True, gen, dev)),
             _check_paged("paged_attention[bf16,long]",
                          _paged_long_case(gen, dev)),
             _check_paged("paged_attention[int8,32 slots,max_len 1280]",
                          _paged_int8_serve_case(gen, dev)),
             _check_paged("paged_attention[bf16,blocks of 8,max_len 1064]",
                          _paged_bench_case(gen, dev))]
    torch.cuda.empty_cache()
    rows = _rows_cases(gen, dev)
    # The serve phase's waves (8 prompts), then the bench's: 16 x 96
    # (bench[engine]), and the monolith's 4 x 816 and 8 x 32
    # (bench[prefix]), whose last tiles are partial.
    flash = [_check_flash(f"flash_attention_fwd[S={S},seg={int(s)}]"
                          + (f"[B={B}]" if B != 8 else ""),
                          _flash_case(S, s, gen, dev, B))
             for B, S, s in ((8, 1024, False), (8, 512, False),
                             (8, 1024, True), (8, 512, True),
                             (16, 96, False), (4, 816, False),
                             (8, 32, False))]
    cases = {"paged_attention": paged, **rows,
             "flash_attention_fwd": flash,
             "flash_attention_bwd_dkv": [], "flash_attention_bwd_dq": []}
    for dtype, segs in ((torch.bfloat16, False), (torch.bfloat16, True),
                        (torch.float32, False)):
        label = f"[{str(dtype).split('.')[-1]},seg={int(segs)}]"
        rows = _check_bwd(label, _bwd_case(dtype, segs, gen, dev))
        for kname, row in rows.items():
            cases[kname].append(row)
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# Phase 4: the main path through the HTTP server
# ---------------------------------------------------------------------------

def _post(url: str, payload: dict):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if payload.get("stream"):
            chunks = [json.loads(line) for line in r.read().splitlines()
                      if line.strip()]
            toks = [t for c in chunks for t in c.get("tokens", [])]
            done = chunks[-1]
            if not done.get("done"):
                raise AssertionError(f"stream ended without done: {done}")
            return {**done, "tokens": toks}
        return json.loads(r.read())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _int8_step_logits(engine, params, ctx):
    """The plain path's logits for the token after ``ctx`` on an int8 KV
    engine, as its decode reads them: ``ctx[:-1]`` prefilled and inserted
    (quantized) into a one-slot int8 cache, then the next decode step of
    ``ctx[-1]`` over those rows (``kvcache.step_logits``, plain
    attention)."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    cfg, dev, bl, qw = engine.cfg, engine.device, engine.kv_block, \
        engine.qweights
    n = len(ctx) - 1
    nb = -(-len(ctx) // bl)
    cache = kvcache.init_paged_cache(cfg, 1, nb, bl, dev, kv_int8=True)
    table = torch.arange(nb + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor([ctx[:-1]], dtype=torch.long, device=dev)
    prefix, _ = kvcache.prefill_batch(
        params, toks, torch.tensor([n], device=dev), cfg,
        plain_attention=True, qweights=qw)
    kvcache.insert(cache, {k: prefix[k][:, 0] for k in ("k", "v")}, 0, n,
                   ctx[-1], table)
    return kvcache.step_logits(params, cache, cfg, table,
                               plain_attention=True, qweights=qw)


def _plain_logits(engine, params, prompt, ctx):
    """The plain path's logits for the token after ``ctx`` (``prompt``
    and the tokens that followed it): on an int8 KV engine, for a token
    read from the cache (any but a wave prompt's first), those of one
    decode step over the quantized context (:func:`_int8_step_logits`);
    else the prefill's."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    from_cache = len(ctx) > len(prompt) or len(prompt) > (
        engine.prefill_chunk or len(prompt))
    if "k_scale" in engine.cache and from_cache:
        return _int8_step_logits(engine, params, ctx)
    bucket = next(s for s in engine.buckets if s >= len(ctx))
    toks = torch.zeros((1, bucket), dtype=torch.long, device=engine.device)
    toks[0, :len(ctx)] = torch.tensor(ctx)
    lens = torch.tensor([len(ctx)], device=engine.device)
    return kvcache.prefill_batch(params, toks, lens, engine.cfg,
                                 plain_attention=True,
                                 qweights=engine.qweights)[1]


# Depth of the float32 int8 legs (llama3-8b has 32 layers): w8a8's noise
# floor is as large at 2 layers as at 32, and the legs hold the smoke's
# time near half its limit.
INT8_FP32_LAYERS = 8
# A relative perturbation of two float32 ulps of the embedding: the size
# of the summation-order noise between two correct attention paths.
W8A8_PROBE = 2.0 ** -22


def _divergence(ref_engine, prompt, got, want, low=None):
    """First step where tokens ``got`` (kernel path) and ``want`` (plain
    path) differ, with the plain path's top-2 logit gap there (read from
    its logits on the shared context, :func:`_plain_logits`) and its
    noise floor: (step, gap, noise), or (None, None, 0.0) when they agree
    throughout. Past a divergence the contexts differ and nothing more
    is comparable. The noise floor is 0 but on a w8a8 engine, where it
    is the largest shift of the plain logits on the same context when
    the embedding moves by two float32 ulps (``W8A8_PROBE``): w8a8
    rounds every projection's activations to int8, so noise of that size
    flips some roundings and moves the logits by far more than float32
    noise does. ``low``, a plain engine on the same weights in bf16
    (``ref_engine`` then holds them in float32): the floor is at least
    twice the largest difference between its logits and
    ``ref_engine``'s on the context."""
    for t, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        ctx = list(prompt) + list(want[:t])
        params = ref_engine.params
        logits = _plain_logits(ref_engine, params, prompt, ctx)
        top2 = logits[0].topk(2).values
        noise = 0.0
        if ref_engine.qweights is not None:
            probe = dict(params, embed=params["embed"] * (1 + W8A8_PROBE))
            noise = (_plain_logits(ref_engine, probe, prompt, ctx)
                     - logits).abs().max().item()
        if low is not None:
            noise = max(noise, 2 * (
                _plain_logits(low, low.params, prompt, ctx).float()
                - logits).abs().max().item())
        return t, (top2[0] - top2[1]).item(), noise
    return None, None, 0.0


def _engine_like(params, cfg, like, dev, **kw):
    """An engine on ``params`` shaped like the server's engine ``like``
    (slots, max_len, buckets, wave cap, KV blocks, chunk); ``kw`` picks
    the attention path, the prefix pool, speculation and the int8
    recipe."""
    from skypilot_tpu_torch.infer import engine as eng
    return eng.InferenceEngine(
        params, cfg, n_slots=like.n_slots, max_len=like.max_len,
        prompt_buckets=like.buckets, max_wave=like.max_wave,
        kv_block=like.kv_block, prefill_chunk=like.prefill_chunk,
        device=dev, **kw)


def _kernel_vs_plain(params, cfg, like, dev, prompts, label, **kw):
    """Greedy tokens of ``prompts`` through two engines configured like
    the server's engine ``like`` (and ``kw``) that differ only in the
    attention path (batch shapes, and so the GEMMs' roundings, are the
    same in both), plus the prefill logits' largest difference on the
    longest prompt. Returns (kernel tokens, plain tokens, the plain
    engine)."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    runs = {}
    for plain in (False, True):
        e = _engine_like(params, cfg, like, dev, plain_attention=plain, **kw)
        runs[plain] = (e, e.generate(prompts, max_new_tokens=32))
    p = max(prompts, key=len)
    toks = torch.zeros((1, like.max_len), dtype=torch.long, device=dev)
    toks[0, :len(p)] = torch.tensor(p)
    n = torch.tensor([len(p)], device=dev)
    qw = kw.get("qweights")
    lk = kvcache.prefill_batch(params, toks, n, cfg, qweights=qw)[1]
    lp = kvcache.prefill_batch(params, toks, n, cfg, plain_attention=True,
                               qweights=qw)[1]
    _log(f"serve[{label}]: prefill logits max |kernel - plain| = "
         f"{(lk - lp).abs().max().item():.4e} (max |logit| "
         f"{lp.abs().max().item():.3f})")
    return runs[False][1], runs[True][1], runs[True][0]


def _long_chunks(engine, dev, card: str) -> None:
    """One 512-token ``prefill_chunk`` of llama3-8b at start 3584 and at
    7680 on the served weights, through a one-slot cache of max_len 8192
    (32 blocks of 256, ~1.1 GB): the chunk's wall time (after a warm-up
    chunk) and, from one profiled chunk, the multi-row body's launches
    and device time beside the matmuls' and the rest's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import paged_attention as pa
    cfg, C, bl, max_len = engine.cfg, 512, 256, 8192
    nb = max_len // bl
    cache = kvcache.init_paged_cache(cfg, 1, nb, bl, dev)
    table = torch.full((1, nb + 1), nb, dtype=torch.int32, device=dev)
    table[0, :nb] = torch.arange(nb, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(1, cfg.vocab_size, (C,), generator=gen, device=dev)

    # The span is the rung of the engine's default ladder (max_len / 8,
    # / 4, / 2, max_len) that covers the chunk's start.
    def chunk(start):
        cache["length"][0] = start
        kvcache.prefill_chunk(
            engine.params, cache, toks, start, C, 0, max_len, cfg,
            engine.sampling_params, table, final=False,
            span=4096 if start < 4096 else None)
        torch.cuda.synchronize()

    for start in (3584, 7680):
        chunk(start)                                   # warm-up
        t0 = time.perf_counter()
        chunk(start)
        wall = (time.perf_counter() - t0) * 1e3
        n0 = pa.paged_attention_rows.launches
        mma0 = pa.paged_attention_rows.mma_launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            chunk(start)
        n = pa.paged_attention_rows.launches - n0
        mma = pa.paged_attention_rows.mma_launches - mma0
        by = {"rows": 0.0, "matmul": 0.0, "other": 0.0}
        for evt in prof.events():
            if getattr(evt, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            name = evt.name.lower()
            cls = ("rows" if "paged_rows_tc" in name else "matmul"
                   if any(k in name for k in ("gemm", "xmma", "cutlass",
                                              "cublas", "nvjet"))
                   else "other")
            by[cls] += evt.time_range.elapsed_us() / 1e3
        rows_ms = by["rows"] / n if n else float("nan")
        _log(f"serve[long chunk]: llama3-8b 512-token chunk at start "
             f"{start}: wall {wall:.2f} ms; multi-row body {n} launches x "
             f"{rows_ms:.4f} ms = {by['rows']:.2f} ms of device time, "
             f"matmul {by['matmul']:.2f} ms, other {by['other']:.2f} ms "
             f"(one profiled chunk); {card}")
        if n != cfg.n_layers or mma:
            raise AssertionError(f"long chunk: {n} launches of the wgmma "
                                 f"multi-row body (expected "
                                 f"{cfg.n_layers}), {mma} of the mma.sync "
                                 f"one (expected 0)")
    del cache


def _batch_bodies(chunk):
    """The serve legs' 9 requests: 7 prompts of 64-900 tokens (seed 0)
    and streamed twins of the first chunked and the first wave prompt.
    Returns (bodies, prompts, twins)."""
    import numpy as np
    from skypilot_tpu_torch.models import llama
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 901, 7).tolist()
    prompts = [rng.integers(1, llama.CONFIGS["llama3-8b"].vocab_size,
                            n).tolist() for n in lens]
    bodies = [{"tokens": p, "max_new_tokens": 32} for p in prompts]
    twins = [next(i for i, n in enumerate(lens) if n > chunk),
             next(i for i, n in enumerate(lens) if n <= chunk)]
    bodies += [{"tokens": prompts[i], "max_new_tokens": 32,
                "stream": True} for i in twins]
    return bodies, prompts, twins


def _sub(tag: str, what: str) -> str:
    """A line tag: ``serve[what]`` on the bf16 leg, ``serve[int8, what]``
    on the int8 one."""
    return f"serve[{what}]" if tag == "serve" else f"{tag[:-1]}, {what}]"


def _serve_leg(engine, tag: str, card: str, chunk: int,
               max_burst: int = 8) -> dict:
    """The port's HTTP server over ``engine`` answers the 9 requests
    (:func:`_batch_bodies`) concurrently, then the shared-prefix pair.
    The kernels' launch counts and the engine's spec counters are set to
    0 just before the batch and read just after. Checked: every kernel
    of the path launched, at least one verify round, the wgmma multi-row
    body once a layer per chunk not skipped by a prefix hit and the
    mma.sync one never, the trailers' chunk counts, every request's
    budget. Returns the batch's launches, results, wall time, TTFTs and
    decode rate, and the pair's."""
    from skypilot_tpu_torch.infer import server as srv
    cfg = engine.cfg
    bodies, prompts, twins = _batch_bodies(chunk)
    port = _free_port()
    # The server coalesces arrivals (for coalesce_s) until a full wave's
    # worth is queued: with the bf16 leg's wave cap at the run's request
    # count, admission starts once all of them are queued, so the wave
    # prompt's twins share one prefill wave, whose GEMM shapes, and so
    # roundings, the streamed twin must reproduce.
    model, httpd = srv.serve(engine, host="127.0.0.1", port=port,
                             max_burst=max_burst, coalesce_s=0.5)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        model.wait_ready(timeout=600)
        url = f"http://127.0.0.1:{port}/generate"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            if json.loads(r.read())["status"] != "ok":
                raise AssertionError(f"{tag}: /health is not ok")
        results = [None] * len(bodies)
        errors = []

        def one(i):
            try:
                results[i] = _post(url, bodies[i])
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        _zero_launches()
        # The engine's own counters, read while the server is idle.
        spec0 = (engine._spec_drafted_total, engine._spec_accepted_total,
                 engine.verify_calls)
        t1 = time.time()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.time() - t1
        launches = _read_launches()
        mma_launches = launches.pop("paged_attention_rows_mma")
        spec = [n - n0 for n, n0 in zip(
            (engine._spec_drafted_total, engine._spec_accepted_total,
             engine.verify_calls), spec0)]
        if errors or any(r is None for r in results):
            raise AssertionError(f"{tag}: requests failed: {errors}")
        pair = _prefix_pair(model, engine, url, cfg, chunk, tag)
    finally:
        httpd.shutdown()
        model.shutdown()
        th.join(timeout=30)
    _log(f"{tag}: {len(bodies)} requests in {wall:.2f} s; launches "
         f"{launches} (K1 merges a slot's chunks inside its own launch: "
         f"no merge kernel, 0 merge launches)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{tag}: kernel {name} never launched on "
                                 f"the main path")
    _log(f"{_sub(tag, 'spec')}: {spec[2]} verify calls (K+1 = 5 "
         f"decode-body launches a layer each, "
         f"{5 * cfg.n_layers * spec[2]} of the "
         f"{launches['paged_attention']} K1 decode launches); drafted "
         f"{spec[0]}, accepted {spec[1]} tokens; per request (drafted, "
         f"accepted, drafter): "
         + ", ".join(f"({r['spec_drafted']}, {r['spec_accepted']}, "
                     f"{r['drafter']})" for r in results))
    if spec[2] <= 0:
        raise AssertionError(f"{tag}: no verify round ran: speculation was "
                             f"never attempted on the main path")
    # Chunked prefill: one multi-row launch a layer per chunk of every
    # prompt longer than the chunk (the repeated prompt counts twice),
    # less the chunks a prefix hit skipped (its trailer's cached_tokens).
    cached = [r["cached_tokens"] for r in results]
    want_chunks = [-(-(len(b["tokens"]) - c) // chunk)
                   if len(b["tokens"]) > chunk else 0
                   for b, c in zip(bodies, cached)]
    want_rows = sum(want_chunks) * cfg.n_layers
    chunked = [len(b["tokens"]) for b, c in zip(bodies, want_chunks) if c]
    _log(f"{tag}: chunked prompts {chunked} ({sum(want_chunks)} chunks; "
         f"cached tokens {cached}): multi-row launches "
         f"{launches['paged_attention_rows']}, expected {want_rows}")
    if launches["paged_attention_rows"] != want_rows or mma_launches:
        raise AssertionError(f"{tag}: the wgmma multi-row body launched "
                             f"{launches['paged_attention_rows']} times "
                             f"(expected {want_rows}), the mma.sync body "
                             f"{mma_launches} (expected 0)")
    trailers = [r.get("prefill_chunks") for r in results[:len(prompts)]]
    if trailers != want_chunks[:len(prompts)]:
        raise AssertionError(f"{tag}: trailers report prefill_chunks "
                             f"{trailers}, expected "
                             f"{want_chunks[:len(prompts)]}")
    for i, r in enumerate(results):
        toks = r["tokens"]
        if len(toks) != 32 and not (toks and toks[-1] == engine.eos_id):
            raise AssertionError(f"{tag}: request {i}: {len(toks)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag}: request {i}: token outside the "
                                 f"vocab")
    ttft = sorted(r["ttft_ms"] for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    decode_s = wall - ttft[0] / 1e3
    tps = (n_tok - len(results)) / decode_s
    _log(f"{tag}: TTFT ms min {ttft[0]:.1f} median "
         f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; decode "
         f"{tps:.1f} tokens/s over {len(results)} requests on {card}")
    for label, is_chunked in (("chunked", True), ("wave", False)):
        part = sorted(r["ttft_ms"] for r, c in zip(results, want_chunks)
                      if bool(c) == is_chunked)
        _log(f"{tag}: TTFT ms of the {len(part)} {label} requests: "
             + ", ".join(f"{t:.1f}" for t in part))
    _log(f"{_sub(tag, 'prefix')}: cold {pair['cold_ttft']:.1f} ms TTFT, "
         f"warm {pair['warm_ttft']:.1f} ms, the warm prompt cold after "
         f"clear_prefix_cache() {pair['recold_ttft']:.1f} ms; {card}")
    return dict(launches=launches, results=results, prompts=prompts,
                twins=twins, wall=wall, ttft=ttft, tps=tps, pair=pair)


def _zero_launches() -> None:
    """Set the serving kernels' launch counts to 0: K2, K1's decode body
    and its two multi-row bodies."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    for f in (fa.flash_attention_fwd, pa.paged_attention,
              pa.paged_attention_rows):
        f.launches = 0
    pa.paged_attention_rows.mma_launches = 0


def _read_launches() -> dict:
    """The counts :func:`_zero_launches` sets, by ``KERNELS`` name."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    n = {f.__name__: f.launches for f in (
        fa.flash_attention_fwd, pa.paged_attention, pa.paged_attention_rows)}
    n["paged_attention_rows_mma"] = pa.paged_attention_rows.mma_launches
    return n


def phase_serve(dev, card: str):
    """Returns {path: {kernel: launches}}: the bf16 leg's 9-request run
    (``serve``), the float32 leg's kernel engine (``serve[fp32]``), the
    float32 int8 legs' (``serve[fp32,int8 KV]`` on the float32 weights,
    ``serve[fp32,int8]`` on them quantized) and the int8 leg's 9-request
    run (``serve[int8]``)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.infer import server as srv

    chunk = 512
    t0 = time.time()
    # The reference server's defaults: chunks of 512, a prefix pool of 8
    # and n-gram speculation at K = 4. The wave cap is the batch's
    # request count (see _serve_leg); it never binds on these waves (at
    # most 5 prompts share a bucket). Decode runs every slot at every
    # step, so it is batch-invariant.
    engine = srv.make_engine("llama3-8b", slots=16, max_len=1024,
                             admit_wave=len(_batch_bodies(chunk)[0]),
                             kv_block=256,
                             prefill_chunk=chunk, prefix_pool=8, spec_k=4,
                             device=dev, seed=SEED)
    cfg = engine.cfg
    torch.cuda.synchronize()
    _log(f"serve: llama3-8b {cfg.n_layers} layers d_model {cfg.d_model} "
         f"({cfg.num_params() / 1e9:.2f}B params, bf16) built in "
         f"{time.time() - t0:.1f} s")
    bf16 = _serve_leg(engine, "serve", card, chunk)
    results, prompts, twins = bf16["results"], bf16["prompts"], bf16["twins"]
    lens = [len(p) for p in prompts]
    # The wave prompt's twins share every program: equal tokens. The
    # chunked prompt's twins share their chunk programs, so their first
    # tokens are equal; they start decoding at different times, so
    # their bursts split the staged and cached columns at other
    # positions, which reorders fp32 sums that bf16 then rounds: from
    # there they may part (reported below with the plain top-2 gap).
    stream_chunk, stream_wave = results[len(prompts):]
    if stream_wave["tokens"] != results[twins[1]]["tokens"]:
        raise AssertionError("streamed tokens differ from the blocking "
                             "ones for the same wave prompt")
    if stream_chunk["tokens"][0] != results[twins[0]]["tokens"][0]:
        raise AssertionError("the streamed twin of a chunked prompt has "
                             "another first token than the blocking one")
    pair = bf16["pair"]
    t, gap, _ = _divergence(engine, pair["prompt"], pair["warm"],
                            pair["recold"])
    _log("serve[prefix, bf16]: the warm request's tokens " + (
        "equal its cold rerun's over 32 steps" if t is None
        else f"part from its cold rerun's at step {t}, plain top-2 gap "
             f"{gap:.3e} (its bursts start at other times)"))

    _long_chunks(engine, dev, card)

    # Kernels against plain attention, same card, same weights, the
    # shortest and the longest prompt. In bf16, the served numbers,
    # any fp32 summation-order difference flips some bf16 roundings and
    # 32 layers carry them to the logits (PERF.md), so the divergence
    # is reported; the 1e-2 gap rule is asserted on the same weights
    # widened to float32, where that noise is gone.
    pick = [int(np.argmin(lens)), int(np.argmax(lens))]
    picked = [prompts[i] for i in pick]
    got, want, ref = _kernel_vs_plain(engine.params, cfg, engine, dev,
                                      picked, "bf16")
    for i, g, w in zip(pick, got, want):
        t, gap, _ = _divergence(ref, prompts[i], g, w)
        _log(f"serve[bf16]: prompt {i} ({lens[i]} tokens): " + (
            "kernel and plain paths agree over 32 steps" if t is None
            else f"paths diverge at step {t}, plain top-2 gap "
                 f"{gap:.3e}") + "; the server gave "
             f"{'the same' if results[i]['tokens'] == g else 'other'} "
             f"tokens as the kernel path")
    t, gap, _ = _divergence(ref, prompts[twins[0]], stream_chunk["tokens"],
                            results[twins[0]]["tokens"])
    _log(f"serve[bf16]: the streamed twin of chunked prompt {twins[0]} " + (
        "equals the blocking one over 32 steps" if t is None
        else f"parts from the blocking one at step {t}, plain top-2 gap "
             f"{gap:.3e}"))
    del ref
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: ({n: w.float() for n, w in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in engine.params.items()}
    want_rows = sum(-(-len(p) // chunk) for p in picked
                    if len(p) > chunk) * cfg.n_layers
    # The float32 leg's kernel engine reads float32 pools: its chunks
    # run the mma.sync multi-row body, counted from 0 here.
    _zero_launches()
    got, want, ref = _kernel_vs_plain(params32, cfg32, engine, dev, picked,
                                      "fp32")
    launches32 = _read_launches()
    _log(f"serve[fp32]: launches {launches32}; the mma.sync multi-row "
         f"body expected {want_rows}")
    if launches32["paged_attention_rows_mma"] != want_rows or not want_rows \
            or launches32["paged_attention_rows"]:
        raise AssertionError(
            f"fp32 leg: the mma.sync multi-row body launched "
            f"{launches32['paged_attention_rows_mma']} times (expected "
            f"{want_rows} > 0), the wgmma body "
            f"{launches32['paged_attention_rows']} (expected 0 on float32 "
            f"pools)")
    for i, g, w in zip(pick, got, want):
        _agree(ref, prompts[i], g, w, f"prompt {i} ({lens[i]} tokens)",
               "kernel and plain paths")
    _spec_and_prefix_fp32(params32, cfg32, engine, dev, picked, got, ref,
                          chunk)
    del ref

    # The float32 int8 legs, on int8 KV pools and the first
    # INT8_FP32_LAYERS layers of the same weights (the serve[int8] leg
    # runs the recipe at full depth): their chunks send bf16 q to int8
    # pools, so they run the wgmma multi-row body, and their decode the
    # decode body on int8 pools. First on the float32 weights (int8 KV
    # alone leaves the paths' logits as close as float32 pools do), then
    # on them quantized once (w8a8), whose activation rounding sets its
    # own noise floor (_divergence), as large at 2 layers as at 32.
    cfg_i8 = dataclasses.replace(cfg32, n_layers=INT8_FP32_LAYERS)
    params_i8 = dict(params32, blocks={
        n: w[:INT8_FP32_LAYERS].clone()
        for n, w in params32["blocks"].items()})
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    want_chunks = want_rows // cfg.n_layers
    launches_kv8 = _fp32_int8_leg(params_i8, cfg_i8, engine, dev, prompts,
                                  pick, chunk, want_chunks,
                                  "fp32, int8 KV", kv_int8=True)
    t0 = time.time()
    w8 = {"blocks": kvcache.quantize_block_weights(params_i8),
          "head": kvcache.quantize_head(params_i8, cfg_i8)}
    params_i8 = kvcache.slim_params(params_i8)
    _log(f"serve[fp32, int8]: llama3-8b float32 weights quantized in "
         f"{time.time() - t0:.1f} s ({INT8_FP32_LAYERS} of {cfg.n_layers} "
         f"layers)")
    launches32i = _fp32_int8_leg(params_i8, cfg_i8, engine, dev, prompts,
                                 pick, chunk, want_chunks,
                                 "fp32, int8", kv_int8=True, qweights=w8)
    del params_i8, w8, engine
    gc.collect()
    torch.cuda.empty_cache()

    launches8 = _serve_int8(dev, card, chunk, bf16)
    return {"serve": bf16["launches"], "serve[fp32]": launches32,
            "serve[fp32,int8 KV]": launches_kv8,
            "serve[fp32,int8]": launches32i, "serve[int8]": launches8}


def _fp32_int8_leg(params, cfg, like, dev, prompts, pick, chunk,
                   want_chunks, leg: str, **kw) -> dict:
    """A float32 int8 leg (``kw``: the int8 recipe's engine options):
    the kernel engine against the plain-attention engine on the shortest
    and the longest prompt, launches counted from 0 (the wgmma
    multi-row body once a layer per chunk, the mma.sync one never, the
    decode body on int8 pools), then speculation and the prefix pair
    (:func:`_spec_and_prefix_fp32`), every token comparison under
    :func:`_agree`. Returns the kernel engine's launches."""
    picked = [prompts[i] for i in pick]
    want_rows = want_chunks * cfg.n_layers
    _zero_launches()
    got, want, ref = _kernel_vs_plain(params, cfg, like, dev, picked, leg,
                                      **kw)
    launches = _read_launches()
    _log(f"serve[{leg}]: launches {launches}; the wgmma multi-row body "
         f"expected {want_rows}, on int8 pools")
    if launches["paged_attention_rows"] != want_rows \
            or launches["paged_attention_rows_mma"] \
            or not launches["paged_attention"]:
        raise AssertionError(
            f"{leg} leg: the wgmma multi-row body launched "
            f"{launches['paged_attention_rows']} times (expected "
            f"{want_rows}), the mma.sync one "
            f"{launches['paged_attention_rows_mma']} (expected 0), the "
            f"decode body {launches['paged_attention']} (expected > 0)")
    for i, g, w in zip(pick, got, want):
        _agree(ref, prompts[i], g, w,
               f"prompt {i} ({len(prompts[i])} tokens)",
               "kernel and plain paths", leg)
    _spec_and_prefix_fp32(params, cfg, like, dev, picked, got, ref, chunk,
                          leg, **kw)
    del ref
    gc.collect()
    return launches


def _serve_int8(dev, card: str, chunk: int, bf16: dict) -> dict:
    """The ``serve[int8]`` leg: the recipe of ``llm/serve-8b-w8a8.yaml``
    as far as the port's server has its flags (``--slots 32 --max-len
    1280 --weights-int8 --kv-int8 --max-burst 32 --admit-wave 4``, with
    the reference server's defaults: chunks of 512, a prefix pool of 8,
    spec K 4; its ``--open-burst`` waits for the rest of the server,
    ROADMAP Queue 1 item 7) at llama3-8b full width and depth, random
    bf16 weights from seed 0 quantized once on the card. Checks the int8
    pools and bf16 scales, the slim weight tree and the device memory
    after the build, then serves the bf16 leg's 9 requests and the
    shared-prefix pair (:func:`_serve_leg`) and profiles one decode
    burst over all 32 slots. Returns the batch's launches."""
    import torch
    from skypilot_tpu_torch.infer import server as srv
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    engine = srv.make_engine("llama3-8b", slots=32, max_len=1280,
                             admit_wave=4, kv_block=256,
                             prefill_chunk=chunk, prefix_pool=8, spec_k=4,
                             kv_int8=True, weights_int8=True, device=dev,
                             seed=SEED)
    torch.cuda.synchronize()
    gc.collect()
    built = time.time() - t0
    cfg = engine.cfg
    c = engine.cache
    if (c["k"].dtype, c["v"].dtype) != (torch.int8, torch.int8) or \
            (c["k_scale"].dtype, c["v_scale"].dtype) != (torch.bfloat16,
                                                         torch.bfloat16):
        raise AssertionError(f"serve[int8]: pools {c['k'].dtype}, scales "
                             f"{c['k_scale'].dtype}; int8 and bf16 "
                             f"expected")
    if set(engine.params) != {"embed", "final_norm", "blocks"} or \
            set(engine.params["blocks"]) != {"ln1", "ln2"}:
        raise AssertionError("serve[int8]: the engine kept float block "
                             "matrices or a float head")
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    # The int8 weights, the bf16 embedding and the int8 KV by the config,
    # and the bytes of every tensor the engine holds (those plus the
    # scales, norms and slot state).
    blocks = L * (2 * d * nh * hd + 2 * d * nkv * hd + 3 * d * ff)
    head, embed = d * v, 2 * v * d
    kv = c["k"].numel() * 2
    scales = c["k_scale"].numel() * 2 * 2

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(t) for t in tree.values())
        return tree.numel() * tree.element_size()

    held = nbytes(engine.params) + nbytes(engine.qweights) + nbytes(c)
    small = held - (blocks + head + embed + kv + scales)
    got = torch.cuda.memory_allocated(dev) - base
    gb = 1e9
    _log(f"serve[int8]: llama3-8b w8a8 + int8 KV built in {built:.1f} s; "
         f"memory_allocated after the build {got / gb:.3f} GB above the "
         f"baseline: weights {(blocks + head + embed + small) / gb:.3f} GB "
         f"(int8 block matrices {blocks / gb:.3f}, int8 head "
         f"{head / gb:.3f}, bf16 embedding {embed / gb:.3f}; scales, "
         f"norms and slot state {small / gb:.4f}), KV int8 "
         f"{kv / gb:.3f} GB + scales {scales / 1e6:.1f} MB "
         f"({c['k'].shape[1]} blocks of 256 rows); "
         f"the bf16 tree would be {cfg.num_params() * 2 / gb:.2f} GB; "
         f"{card}")
    # The smallest float block matrix (wk in bf16) is 0.27 GB.
    if not 0 <= small < 0.01 * gb or not held <= got <= held + 0.1 * gb:
        raise AssertionError(f"serve[int8]: {got / gb:.3f} GB allocated, "
                             f"the engine holds {held / gb:.3f} GB, "
                             f"{(held - small) / gb:.3f} GB of int8 "
                             f"weights, bf16 embedding and int8 KV: a "
                             f"float copy stayed resident")
    int8 = _serve_leg(engine, "serve[int8]", card, chunk, max_burst=32)
    med = [r['ttft'][len(r['ttft']) // 2] for r in (int8, bf16)]
    _log(f"serve[int8] beside serve (one call, {card}): TTFT ms median "
         f"{med[0]:.1f} (max {int8['ttft'][-1]:.1f}) against {med[1]:.1f} "
         f"(max {bf16['ttft'][-1]:.1f}); decode {int8['tps']:.1f} against "
         f"{bf16['tps']:.1f} tokens/s; wall {int8['wall']:.2f} against "
         f"{bf16['wall']:.2f} s; prefix pair warm/cold TTFT "
         f"{int8['pair']['warm_ttft']:.1f}/{int8['pair']['recold_ttft']:.1f} "
         f"against {bf16['pair']['warm_ttft']:.1f}/"
         f"{bf16['pair']['recold_ttft']:.1f} ms")
    _profile_int8_burst(engine, card)
    del engine
    _int_mm_layouts(dev, card)
    return int8["launches"]


def _int_mm_layouts(dev, card: str) -> None:
    """``torch._int_mm`` at llama3-8b's w8a8 shapes with the weight
    column-major (``kvcache.int8_layout``, what the port stores) and
    row-major: the time of each (CUDA events), or the error that refuses
    it."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for m, k, n in ((17, 4096, 4096), (17, 4096, 14336), (17, 14336, 4096),
                    (512, 4096, 14336), (17, 4096, 128256)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        times = []
        for b in (w.t().contiguous().t(), w):
            try:
                ms = _time_ms(lambda i: torch._int_mm(a, b), 20)
                times.append(f"{ms:.4f} ms")
            except RuntimeError as e:
                times.append(f"refused ({str(e).splitlines()[0][:60]})")
        _log(f"serve[int8, _int_mm]: {m}x{k}x{n}: column-major weight "
             f"{times[0]}, row-major {times[1]}; {card}")


def _profile_int8_burst(engine, card: str) -> None:
    """All 32 slots decoding (prompts of 330-500 tokens, so every slot
    sits on the span rung of 640 rows and a burst is one group): one
    8-step decode burst timed on the host, then one profiled, its device
    time
    split by class: ``torch._int_mm`` (the kernels the
    ``aten::_int_mm`` op launched), the quantizers (the kernels of ops
    run inside ``_act_quant`` and ``quantize_rows``, marked for this
    burst by ``record_function``), K1's decode body (by kernel name) and
    the rest."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED + 2)
    for n in rng.integers(330, 501, engine.n_slots):
        engine.add_request(
            rng.integers(1, engine.cfg.vocab_size, n).tolist(), 64)
    engine.admit()
    if len(engine.slot_req) != engine.n_slots:
        raise AssertionError(f"serve[int8, decode burst]: "
                             f"{len(engine.slot_req)} of {engine.n_slots} "
                             f"slots admitted")
    k = 8
    engine.complete_decode_burst(engine.dispatch_decode_burst(k))   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.complete_decode_burst(engine.dispatch_decode_burst(k))
    wall = (time.perf_counter() - t0) * 1e3
    label = "w8a8.quantize"
    real = (kvcache._act_quant, kvcache.quantize_rows)

    def marked(fn):
        def inner(*a):
            with record_function(label):
                return fn(*a)
        return inner

    n0 = pa.paged_attention.launches
    kvcache._act_quant, kvcache.quantize_rows = map(marked, real)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            handle = engine.dispatch_decode_burst(k)
            engine.complete_decode_burst(handle)
            torch.cuda.synchronize()
    finally:
        kvcache._act_quant, kvcache.quantize_rows = real
    n_k1 = pa.paged_attention.launches - n0
    groups = len(handle.parts)
    by = {"int_mm": 0.0, "quantizers": 0.0, "K1": 0.0, "total": 0.0}
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.events():
        if getattr(evt, "device_type", None) == cuda:
            if evt.name != label:
                ms = evt.time_range.elapsed_us() / 1e3
                by["total"] += ms
                if "paged_attention_kernel" in evt.name:
                    by["K1"] += ms
            continue
        kernels = sum(kn.duration for kn in getattr(evt, "kernels", ())
                      ) / 1e3
        # A kernel belongs to the innermost op that launched it; its
        # class is that of the nearest marked ancestor, itself included.
        up = evt
        while kernels and up is not None and up.name not in (
                "aten::_int_mm", label):
            up = up.cpu_parent
        if kernels and up is not None:
            by["int_mm" if up.name == "aten::_int_mm"
               else "quantizers"] += kernels
    rest = by["total"] - by["int_mm"] - by["quantizers"] - by["K1"]
    _log(f"serve[int8, decode burst]: {engine.n_slots} slots x {k} steps "
         f"in {groups} span group(s): "
         f"wall {wall:.2f} ms unprofiled ({wall / k:.2f} ms a step); one "
         f"profiled burst's device time {by['total']:.2f} ms: _int_mm "
         f"{by['int_mm']:.2f}, quantizers {by['quantizers']:.2f}, K1 "
         f"decode body {by['K1']:.2f} ({n_k1} launches), rest {rest:.2f}; "
         f"{card}")
    want = k * engine.cfg.n_layers * groups
    if n_k1 != want or groups != 1 or not by["int_mm"] or \
            not by["quantizers"] or not by["K1"]:
        raise AssertionError(f"serve[int8, decode burst]: {n_k1} K1 "
                             f"launches (expected {want}) in {groups} span "
                             f"groups (expected 1), or a class with no "
                             f"device time: {by}")
    engine.reset()


def _agree(ref, prompt, got, want, what: str, paths: str,
           leg: str = "fp32", low=None) -> None:
    """Greedy tokens ``got`` and ``want`` of ``prompt`` agree, or part
    only where the plain logits' top-2 gap is at most 1e-2 (a near-tie,
    which fp32 summation order may flip) or, on a w8a8 engine or with
    ``low`` (bf16 tokens), at most the noise floor there
    (:func:`_divergence`)."""
    t, gap, noise = _divergence(ref, prompt, got, want, low)
    bound = max(1e-2, noise)
    kind = ("w8a8" if ref.qweights is not None
            else "bf16" if low is not None else None)
    floor = f", {kind} noise floor {noise:.3e}" if kind else ""
    if t is not None and gap > bound:
        raise AssertionError(
            f"{leg}: {paths} differ on {what} at step {t} where the plain "
            f"top-2 logit gap is {gap:.4f} > {bound:.4f} (1e-2{floor})")
    _log(f"serve[{leg}]: {what}: " + (
        f"{paths} agree over {len(got)} steps" if t is None
        else f"{paths} diverge at step {t} on a near-tie (plain top-2 gap "
             f"{gap:.3e} <= {bound:.3e}: 1e-2{floor})"))


class _Replay:
    """Drafter factory (the engine's ``spec_drafter`` seam) that replays
    each prompt's known greedy continuation: the oracle, or with
    ``shift`` an anti-oracle whose every draft token is wrong."""

    def __init__(self, outputs, shift: int = 0, vocab: int = 0):
        self.outputs, self.shift, self.vocab = outputs, shift, vocab

    def __call__(self, req):
        return _Replay._Drafter(self, self.outputs[tuple(req.prompt)])

    class _Drafter:
        def __init__(self, factory, out):
            self.f, self.out, self.seen = factory, out, 0

        def catch_up(self, prompt, generated):
            self.seen = len(generated)

        def draft(self, k):
            nxt = self.out[self.seen:self.seen + k]
            if not self.f.shift:
                return list(nxt)
            return [(t + self.f.shift) % self.f.vocab for t in nxt]


def _spec_and_prefix_fp32(params, cfg, like, dev, prompts, spec_off, ref,
                          chunk, leg: str = "fp32", **kw) -> None:
    """The float32 legs' speculation and prefix checks, on the kernel
    path with the server engine's shapes (and ``kw``, the int8 recipe's
    options on the int8 legs; ``leg`` names the leg): greedy tokens with
    spec_k 4 and an oracle drafter (every verify position accepts, so
    K1's decode body runs at every window position) and with an
    anti-oracle (every draft rejected, none accepted) equal the spec-off
    tokens; a warm prefix hit equals its cold run after
    clear_prefix_cache(). Tokens that differ are held to :func:`_agree`'s
    rule."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa

    def engine(**more):
        return _engine_like(params, cfg, like, dev, **kw, **more)

    outputs = {tuple(p): t for p, t in zip(prompts, spec_off)}
    for label, factory in (
            ("oracle", _Replay(outputs)),
            ("anti-oracle", _Replay(outputs, 1, cfg.vocab_size))):
        e = engine(spec_k=4, spec_drafter=factory)
        e.spec_min_rate = 0.0         # keep drafting to the end
        d0 = pa.paged_attention.launches
        got = e.generate(prompts, max_new_tokens=32)
        drafted, accepted = e._spec_drafted_total, e._spec_accepted_total
        _log(f"serve[{leg}, spec {label}]: {e.verify_calls} verify calls, "
             f"drafted {drafted}, accepted {accepted}; K1 decode launches "
             f"{pa.paged_attention.launches - d0}")
        if not e.verify_calls or not drafted:
            raise AssertionError(f"{leg} {label}: no verify round ran")
        if label == "anti-oracle" and accepted:
            raise AssertionError(f"{leg} anti-oracle accepted {accepted}")
        if label == "oracle" and got == spec_off and accepted != drafted:
            raise AssertionError(f"{leg} oracle accepted {accepted} of "
                                 f"{drafted}")
        for p, g, w in zip(prompts, got, spec_off):
            _agree(ref, p, g, w, f"{len(p)}-token prompt, {label}",
                   "spec-on and spec-off tokens", leg)
        del e
        gc.collect()
        torch.cuda.empty_cache()
    cold_p, warm_p = _pair_prompts(cfg, chunk)
    e = engine(prefix_pool=8, spec_k=4)
    e.generate([cold_p], max_new_tokens=32)
    e.finished.clear()
    warm = e.generate([warm_p], max_new_tokens=32)[0]
    cached = e.finished[0].cached_len
    e.finished.clear()
    e.clear_prefix_cache()
    cold = e.generate([warm_p], max_new_tokens=32)[0]
    if cached != chunk or e.finished[0].cached_len:
        raise AssertionError(f"{leg} prefix pair: cached {cached} warm, "
                             f"{e.finished[0].cached_len} cold")
    _agree(ref, warm_p, warm, cold, f"{len(warm_p)}-token prompt",
           "warm (512 cached) and cold tokens", leg)
    del e
    gc.collect()
    torch.cuda.empty_cache()


def _pair_prompts(cfg, chunk):
    """Two prompts sharing a 600-token prefix, 820 and 760 tokens long:
    the first stores its first 512 tokens, the second hits them."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(1, cfg.vocab_size, 600).tolist()
    return (shared + rng.integers(1, cfg.vocab_size, 220).tolist(),
            shared + rng.integers(1, cfg.vocab_size, 160).tolist())


def _prefix_pair(model, engine, url, cfg, chunk, tag: str) -> dict:
    """The shared-prefix pair through the server, one after the other,
    then the second again after clear_prefix_cache(): the first reports
    no hit and 2 chunks, the second a 512-token hit and 1 chunk whose
    multi-row launches (32) read the first's shared blocks from start
    512, and the rerun no hit again."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    # One request at a time: the server's default admission window
    # (12 ms), not the batch's 0.5 s, so TTFT is the prefill's.
    model.coalesce_s = 0.012
    cold_p, warm_p = _pair_prompts(cfg, chunk)
    out = {}
    for label, prompt, want in (
            ("cold", cold_p, (False, 0, 2)), ("warm", warm_p,
                                              (True, chunk, 1)),
            ("recold", warm_p, (False, 0, 2))):
        if label == "recold":
            # The loop thread touches the engine only while a request is
            # in flight; none is.
            engine.clear_prefix_cache()
        pa.paged_attention_rows.launches = 0
        hits = engine.prefix_hits
        r = _post(url, {"tokens": prompt, "max_new_tokens": 32})
        rows = pa.paged_attention_rows.launches
        got = (r["cache_hit"], r["cached_tokens"], r["prefill_chunks"])
        _log(f"{_sub(tag, 'prefix')}: {label} {len(prompt)}-token prompt: "
             f"cache_hit {got[0]}, cached_tokens {got[1]}, prefill_chunks "
             f"{got[2]}, multi-row launches {rows}, TTFT {r['ttft_ms']} "
             f"ms, spec drafted {r['spec_drafted']} accepted "
             f"{r['spec_accepted']}")
        if got != want or rows != want[2] * cfg.n_layers \
                or engine.prefix_hits - hits != int(want[0]):
            raise AssertionError(
                f"{tag} prefix pair, {label}: (cache_hit, cached_tokens, "
                f"prefill_chunks) {got}, expected {want}; multi-row "
                f"launches {rows}, expected {want[2] * cfg.n_layers}")
        out[label] = r["tokens"]
        out[f"{label}_ttft"] = r["ttft_ms"]
    out["prompt"] = warm_p
    return out


# name: (route, source, the TPU kernel it replaces)
KERNELS = {
    "paged_attention": ("cuda", "skypilot_tpu_torch/csrc/paged_attention.cu",
                        "skypilot_tpu/ops/paged_attention.py:67"),
    # The same TPU kernel's chunk-path use (C * rep rows a kv-head):
    # the wgmma + TMA body (bf16 q on bf16 or int8 pools) and the
    # mma.sync body (float32 pools).
    "paged_attention_rows": ("cuda",
                             "skypilot_tpu_torch/csrc/paged_attention.cu",
                             "skypilot_tpu/ops/paged_attention.py:67"),
    "paged_attention_rows_mma": ("cuda",
                                 "skypilot_tpu_torch/csrc/paged_attention.cu",
                                 "skypilot_tpu/ops/paged_attention.py:67"),
    "flash_attention_fwd": ("cuda", "skypilot_tpu_torch/csrc/flash_fwd.cu",
                            "skypilot_tpu/ops/flash_attention.py:58"),
    "flash_attention_bwd_dkv": ("cuda",
                                "skypilot_tpu_torch/csrc/flash_bwd.cu",
                                "skypilot_tpu/ops/flash_attention.py:170"),
    "flash_attention_bwd_dq": ("cuda", "skypilot_tpu_torch/csrc/flash_bwd.cu",
                               "skypilot_tpu/ops/flash_attention.py:226"),
}


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, segment_ids=None):
    """Causal einsum attention on GQA-expanded K/V, which autograd
    differentiates independently of the kernels' formula."""
    from skypilot_tpu_torch.ops import attention
    rep = q.shape[2] // k.shape[2]
    return attention.xla_attention(q, attention.repeat_kv(k, rep),
                                   attention.repeat_kv(v, rep), causal=True,
                                   segment_ids=segment_ids)


def _grad_parity(dev, dtype) -> dict:
    """llama3-1b width (d_model 2048, 16/8 heads, head_dim 128, d_ff
    8192, vocab 128256) at 2 layers, one packed batch of 2 x 2048: loss
    and gradients through the kernels and through autograd of einsum
    attention, on the same card and weights. Returns the loss difference
    and, per parameter (over all its layers), max|kernel - plain| /
    max|plain|."""
    import torch
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-1b"], n_layers=2,
                              dtype=dtype, xent_chunk=512)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, gen, device=dev)
    docs = ip.synthetic_doc_stream(64, cfg.vocab_size, mean_len=600,
                                   seed=SEED)
    batch = ip.to_device(next(ip.packed_batches(docs, 2, 2048)), dev)
    got = trainer.grads_of(params, batch, cfg)
    want = trainer.grads_of(params, batch, cfg, attention=_plain_attention)
    # One name per entry of the gradient lists: a stacked block tensor
    # gives one gradient per layer.
    names = [f"{k}.{n}" if k == "blocks" else k
             for k, w in params.items()
             for n in (w if k == "blocks" else [None])
             for _ in range(w[n].shape[0] if k == "blocks" else 1)]
    diff, scale = {}, {}
    for n, g, w in zip(names, got[2], want[2]):
        diff[n] = max(diff.get(n, 0.0), (g - w).abs().max().item())
        scale[n] = max(scale.get(n, 0.0), w.abs().max().item())
    return {"loss_kernel": got[0].item(), "loss_plain": want[0].item(),
            "grad_rel": {n: diff[n] / scale[n] for n in diff}}


def _tree_equal(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _run_main(argv) -> dict:
    """``train.run.main`` with its summary line kept off this script's
    stdout (whose last two lines are the contract's)."""
    import contextlib
    import io
    from skypilot_tpu_torch.train import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run.main(argv)
    _log(f"train: run.main({' '.join(argv)}) -> {buf.getvalue().strip()}")
    return res


def _profile_train_step(dev, card: str) -> None:
    """One llama3-1b step (batch 4 x 2048, after a warm-up step) under
    torch.profiler: device time by kernel class and the device's idle
    share of the step's wall time (kernels run on one stream, so their
    times add up without overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import trainer
    cfg = dataclasses.replace(llama.CONFIGS["llama3-1b"], xent_chunk=512)
    tc = trainer.TrainConfig(warmup_steps=1, total_steps=6)
    state = trainer.create_train_state(cfg, tc, dev)
    step = trainer.make_train_step(cfg, tc)
    batch = trainer.synthetic_batch(cfg, 4, 2048, device=dev)
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    classes = {"K2 flash_fwd": ("flash_fwd",), "K3 flash_bwd_dkv":
               ("flash_bwd_dkv",), "K4 flash_bwd_dq": ("flash_bwd_dq",),
               "matmul": ("gemm", "xmma", "cutlass", "cublas", "nvjet")}
    by = {c: 0.0 for c in list(classes) + ["other"]}
    other = {}
    n = 0
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        name = evt.name.lower()
        cls = next((c for c, keys in classes.items()
                    if any(k in name for k in keys)), "other")
        by[cls] += us / 1e3
        if cls == "other":
            other[evt.name] = other.get(evt.name, 0.0) + us / 1e3
        n += 1
    busy = sum(by.values())
    if n == 0:
        _log("train[profile]: the profiler recorded no device activity; "
             "device time by kernel not measured")
        return
    _log(f"train[profile]: llama3-1b step wall {wall_ms:.1f} ms under the "
         f"profiler; {n} device activities, busy {busy:.1f} ms, idle "
         f"share {max(0.0, 1 - busy / wall_ms):.3f}; device ms by class "
         + ", ".join(f"{c} {t:.1f}" for c, t in by.items()) + f"; {card}")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    _log("train[profile]: largest 'other' kernels (ms): "
         + "; ".join(f"{t:.1f} {name[:90]}" for name, t in top))


@contextlib.contextmanager
def _tap(module, name: str, seen: list, keep=None):
    """Wrap ``module.name`` for the block: each call's result (or
    ``keep`` of it) is appended to ``seen``; the result is returned."""
    real = getattr(module, name)

    def tapped(*a, **kw):
        out = real(*a, **kw)
        seen.append(keep(out) if keep else out)
        return out

    setattr(module, name, tapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _path_shapes(seen: dict):
    """Record, for the block, each distinct shape at which the serving
    path reaches K1 (``kvcache._paged_attn_stats`` off the plain path)
    and K2 (``attention.gqa_attention``). ``seen`` maps each shape to
    [calls, inputs to rebuild it]: K1's table and lengths (cloned at the
    first call), K2's segment ids and causal flag. It records only: the
    wrappers and their launch counts are untouched."""
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.ops import attention as attn_ops
    real_k1, real_k2 = kvcache._paged_attn_stats, attn_ops.gqa_attention

    def note(key, make):
        if key not in seen:
            seen[key] = [0, make()]
        seen[key][0] += 1

    def k1(cache, i, table, qh, lengths, span, plain=False):
        if not plain:
            k = cache["k"]
            M = span if span is not None else kvcache._logical_rows(
                cache, table)
            note(("K1", tuple(qh.shape), qh.dtype, tuple(k.shape[1:]),
                  k.dtype, tuple(table.shape), -(-M // k.shape[2])),
                 lambda: (table.clone(), lengths.clone()))
        return real_k1(cache, i, table, qh, lengths, span, plain)

    def k2(q, k, v, causal=True, segment_ids=None):
        note(("K2", tuple(q.shape), tuple(k.shape), q.dtype, causal,
              segment_ids is not None),
             lambda: (None if segment_ids is None
                      else segment_ids.clone()))
        return real_k2(q, k, v, causal, segment_ids)

    kvcache._paged_attn_stats, attn_ops.gqa_attention = k1, k2
    try:
        yield
    finally:
        kvcache._paged_attn_stats, attn_ops.gqa_attention = real_k1, real_k2


def _check_path_shapes(seen: dict, leg: str, dev) -> None:
    """K1 and K2 against their plain versions at every shape that
    :func:`_path_shapes` recorded, under the kernel phase's tolerances:
    random q, K and V (pools of two layers, read at layer 1) at the
    path's shapes, with its recorded table, lengths and span, or
    segment ids. Run after a leg's launches are read, so they count on
    no path."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kv_name = {torch.bfloat16: "bf16", torch.int8: "int8",
               torch.float32: "f32"}
    pools, errs, shapes = {}, {"K1": 0.0, "K2": 0.0}, []
    for key, (n, saved) in seen.items():
        if key[0] == "K1":
            _, qshape, qdtype, pshape, kvdtype, tshape, sb = key
            B, G, R, hd = qshape
            name = (f"{leg} K1 B={B} R={R} blocks of {pshape[1]} "
                    f"x {tshape[1] - 1} span {sb}")
            if (pshape, kvdtype) not in pools:
                pools[(pshape, kvdtype)] = _rows_pools(
                    (2,) + pshape, kv_name[kvdtype], gen, dev)
            kp, vp, ks, vs = pools[(pshape, kvdtype)]
            table, lengths = saved
            case = dict(q=torch.randn(qshape, generator=gen, device=dev,
                                      dtype=qdtype),
                        k_pool=kp, v_pool=vp, k_scale=ks, v_scale=vs,
                        table=table, lengths=lengths, layer=1,
                        span_blocks=sb)
            from skypilot_tpu_torch.ops import paged_attention as pa
            err = _paged_err(name, case, pa.paged_attention)
            shapes.append(f"K1 B={B} R={R} bl={pshape[1]} span={sb} x{n}")
        else:
            _, qshape, kshape, dtype, causal, _ = key
            name = f"{leg} K2 {qshape}"

            def randn(shape):
                return torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype)

            err = _flash_err(name, dict(q=randn(qshape), k=randn(kshape),
                                        v=randn(kshape), seg=saved,
                                        causal=causal))[0]
            shapes.append(f"K2 B={qshape[0]} S={qshape[1]} x{n}")
        errs[key[0]] = max(errs[key[0]], err)
    del pools
    torch.cuda.empty_cache()
    _log(f"{leg}: the kernels agree with their plain versions at "
         f"all {len(seen)} shapes of the leg (max err K1 "
         f"{errs['K1']:.3e}, K2 {errs['K2']:.3e}): " + "; ".join(shapes))


def _bf16_divergence(dev, config: str, chunk: int, cold: dict,
                     passes, leg: str = "bench") -> None:
    """Hold each prompt whose tokens in a pass of ``passes`` ((what the
    two paths are, {prompt: tokens}) pairs) part from its ``cold`` ones
    to :func:`_agree`'s rule, with the top-2 gap taken from a plain engine
    on a float32 copy of the bench's weights (seed 0) and the noise
    floor from the same context in bf16: twice the largest difference
    between the bf16 and float32 plain logits there, since each bf16
    pass may move that far from the float32 logits."""
    import torch
    from skypilot_tpu_torch.infer import engine as eng
    from skypilot_tpu_torch.models import llama
    if all(warm[p] == c for _, warm in passes for p, c in cold.items()):
        return
    cfg = llama.CONFIGS[config]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    refs = {}
    for c, p in ((cfg, params), (dataclasses.replace(
            cfg, dtype=torch.float32), {k: ({n: w.float() for n, w in
                                             v.items()}
                                            if isinstance(v, dict)
                                            else v.float())
                                        for k, v in params.items()})):
        refs[c.dtype] = eng.InferenceEngine(
            p, c, n_slots=1, max_len=1024, prompt_buckets=(1024,),
            prefill_chunk=chunk, device=dev, plain_attention=True)
    del params
    for paths, warm in passes:
        for i, (prompt, c) in enumerate(cold.items()):
            if warm[prompt] != c:
                _agree(refs[torch.float32], list(prompt), warm[prompt], c,
                       f"request {i}", paths, leg, low=refs[torch.bfloat16])
    del refs
    gc.collect()
    torch.cuda.empty_cache()


def _positive(report: dict, keys, leg: str) -> None:
    for k in keys:
        v = report[k]
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"bench[{leg}]: {k} = {v!r}, expected a "
                                 f"finite positive number")


def phase_bench(dev, card: str) -> dict:
    """The port's serving bench (``infer/bench_serve.py``) at llama3-8b,
    full width and depth, bf16, random weights from seed 0, through its
    own functions: ``run_http`` (8 streamed requests of mixed 512-1024
    tokens, three timed waves), ``run`` (16 requests of 96 tokens on the
    engine alone) and ``run_prefix_share`` at its full-size defaults.
    The launch counts are set to 0 just before each leg and read just
    after; then the kernels are held against their plain versions at
    each shape the leg gave them. Returns the launches by kernel,
    summed over the legs."""
    import torch
    from skypilot_tpu_torch.infer import bench_serve as bs
    from skypilot_tpu_torch.infer import engine as eng

    config, total = "llama3-8b", {}

    def leg(name: str, fn):
        seen = {}
        with _path_shapes(seen):
            _zero_launches()
            t0 = time.time()
            out = fn()
            n = _read_launches()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        _log(f"bench[{name}]: {json.dumps(out)}")
        _log(f"bench[{name}]: {time.time() - t0:.1f} s, launches {n}; "
             f"{card}")
        gc.collect()
        torch.cuda.empty_cache()
        _check_path_shapes(seen, f"bench[{name}]", dev)
        return out

    # 1. HTTP: every response 200 (the client raises otherwise) with its
    # 32 tokens, in the warmup wave and the three timed ones.
    waves = []
    with _tap(bs, "_client_wave", waves):
        http = leg("http", lambda: bs.run_http(
            config=config, requests=8, slots=16, new_tokens=32,
            max_burst=8, open_burst=4, admit_wave=4, repeats=3,
            device=dev))
    counts = [[n for _, n, _ in res] for res in waves]
    if counts != [[32] * 8] * 4:
        raise AssertionError(f"bench[http]: tokens per response {counts}, "
                             f"expected 4 waves of 8 x 32")
    _positive(http, ("median_ttft_ms", "p99_ttft_ms", "out_tok_s",
                     "tpot_ms"), "http")
    if http["transport"] != "http_streaming":
        raise AssertionError(f"bench[http]: transport {http['transport']}")

    # 2. The engine alone: 16 requests finished, 64 tokens each.
    built = []
    with _tap(bs, "_build_engine", built):
        engine_only = leg("engine", lambda: bs.run(
            config=config, requests=16, slots=16, prompt_len=96,
            new_tokens=64, max_burst=32, device=dev))
    done = [len(r.tokens) for r in built[0][1].finished]
    del built
    if done != [64] * 16:
        raise AssertionError(f"bench[engine]: tokens per request {done}, "
                             f"expected 16 x 64")
    _positive(engine_only, ("median_ttft_ms", "out_tok_s"), "engine")

    # 3. Prefix share at the reference's full-size defaults: a system
    # prompt of 768 tokens and tails of 48, chunks of 256, 12 requests.
    # The engine's drains, as token maps by prompt: two one-request
    # warmups, then the cold and the warm pass.
    passes = []
    with _tap(eng.InferenceEngine, "run_to_completion", passes,
              keep=lambda done: {tuple(r.prompt): list(r.tokens)
                                 for r in done}):
        pfx = leg("prefix", lambda: bs.run_prefix_share(
            config=config, device=dev))
    if not (pfx["cold_hits"] == 0 and pfx["hit_rate"] == 1.0
            and pfx["warm_chunks"] == pfx["requests"] < pfx["cold_chunks"]
            and pfx["interference"]["admission_bursts"] > 0):
        raise AssertionError(f"bench[prefix]: structure {pfx}")
    cold, warm = [p for p in passes if len(p) == pfx["requests"]][:2]
    if (cold == warm) != pfx["parity_ok"]:
        raise AssertionError("bench[prefix]: the drains read here are not "
                             "the passes the report compared")
    if not pfx["parity_ok"]:
        # bf16 batches differ between the passes.
        _bf16_divergence(dev, config, pfx["prefill_chunk"], cold,
                         [("warm and cold passes", warm)])

    for k in ("paged_attention", "paged_attention_rows",
              "flash_attention_fwd"):
        if not total.get(k):
            raise AssertionError(f"bench: {k} never launched ({total})")
    if total["paged_attention_rows_mma"]:
        raise AssertionError(f"bench: bf16 chunks ran the mma.sync "
                             f"multi-row body ({total}): the engine chose "
                             f"a block length the wgmma body does not "
                             f"read")
    return total


# ---------------------------------------------------------------------------
# The cross-replica KV handoff
# ---------------------------------------------------------------------------

def _handoff_prompts(cfg):
    """The handoff legs' prompts (seed 0): 775 and 597 tokens, both
    handed off over a 512-row prefix, and 491, which cannot hand off
    (its context plus one token does not pass one chunk)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    return [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (775, 597, 491)]


def _tiers(params, cfg, dev, slots: int, max_len: int, **kw):
    """A prefill tier P and a decode tier D: two engines on one params
    tree with the serving defaults ``make_engine`` gives them (prompt
    buckets, waves of 8, blocks of 256, chunks of 512, a prefix pool of
    8, spec K 4); ``kw``: the int8 recipe's options."""
    from skypilot_tpu_torch.infer import engine as eng
    buckets = tuple(sorted({128, 512, max_len}))
    return [eng.InferenceEngine(
        params, cfg, n_slots=slots, max_len=max_len, prompt_buckets=buckets,
        max_wave=8, kv_block=256, prefill_chunk=512, prefix_pool=8,
        spec_k=4, device=dev, seed=SEED, **kw) for _ in "PD"]


def _fill_trash(engine) -> None:
    """The trash block (every table entry past a slot's blocks) holds
    100.0: a read that leaks past a slot's rows shows at once."""
    n = engine.n_kv_blocks
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in engine.cache:
            engine.cache[name][:, n] = 100


@contextlib.contextmanager
def _timed(obj, name: str, out: list, sync: bool = False):
    """Wrap ``obj.name`` (a module's function or an instance's method)
    for the block: each call appends (ms, args, result)."""
    import torch
    real = getattr(obj, name)
    own = name in vars(obj)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        res = real(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, a, res))
        return res

    setattr(obj, name, timed)
    try:
        yield
    finally:
        if own:
            setattr(obj, name, real)
        else:
            delattr(obj, name)


def _post_raw(url: str, body: bytes):
    """POST ``body``; returns (status, response bytes)."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _stream_timed(url: str, body: bytes, n_seeds: int):
    """POST a streamed ``body``; returns (tokens, the done line, ms from
    the send to the first token past the ``n_seeds`` committed ones, ms
    from that token to the done line)."""
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    toks, first = [], None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if not line.strip():
                continue
            obj = json.loads(line)
            if "error" in obj:
                raise AssertionError(f"handoff stream error: {obj}")
            if obj.get("done"):
                now = time.perf_counter()
                return toks, obj, (first - t0) * 1e3, (now - first) * 1e3
            toks.extend(obj.get("tokens") or [])
            if first is None and len(toks) > n_seeds:
                first = time.perf_counter()
    raise AssertionError("handoff stream ended without done")


@contextlib.contextmanager
def _first_rows_call(engine, out: list):
    """Record, for the block, the inputs of the first multi-row K1 call
    on ``engine``'s cache: (layer, table, q, lengths, span)."""
    from skypilot_tpu_torch.infer import kvcache
    real = kvcache._paged_attn_stats
    rep = engine.cfg.n_heads // engine.cfg.n_kv_heads

    def keep(cache, i, table, qh, lengths, span, plain=False):
        if cache is engine.cache and qh.shape[2] > rep and not out:
            out.append((i, table.clone(), qh.clone(), lengths.clone(),
                        span))
        return real(cache, i, table, qh, lengths, span, plain)

    kvcache._paged_attn_stats = keep
    try:
        yield
    finally:
        kvcache._paged_attn_stats = real


def _handoff_leg(P, D, tag: str, card: str, new: int = 32) -> dict:
    """P (prefill tier) and D (decode tier) behind two HTTP servers on
    one card. First the single-tier reference: each handoff prompt on
    D's ``/generate``, then ``clear_prefix_cache()``. Then, launch
    counts set to 0 and K1's shapes recorded: each prompt's ``/prefill``
    on P (one committed token and the export, on the reference's wire)
    and, D's prefix cache cleared before each, its ``/handoff`` on D,
    blocking and then streamed. Checked: the committed token is the
    single tier's first; every handoff imported the 512-row prefix (the
    import's rows, D's ``prefix_hits`` up by one, the request's
    ``resumed_len`` 512); the stream starts with the committed token;
    ``/prefill`` of the 491-token prompt gets the typed 409; afterwards
    each tier's blocks are its resident entries'. D's trash block holds
    100.0 before the leg and again when K1 is held against its plain
    version on D's own cache (the imported blocks) at the first resume
    chunk's inputs. Returns the launches and the token maps."""
    import torch
    from skypilot_tpu_torch.infer import server as srv
    from skypilot_tpu_torch.ops import paged_attention as pa
    prompts = _handoff_prompts(D.cfg)
    handed, short = prompts[:2], prompts[2]
    _fill_trash(D)
    servers = []
    for e in (P, D):
        port = _free_port()
        model, httpd = srv.serve(e, host="127.0.0.1", port=port)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers.append((model, httpd, th, f"http://127.0.0.1:{port}"))
    purl, durl = servers[0][3], servers[1][3]
    out = {"single": {}, "blocking": {}, "stream": {}}
    seen, resume = {}, []
    calls = {k: [] for k in ("export", "encode", "decode", "import",
                             "retire")}
    try:
        for model, *_ in servers:
            model.wait_ready(timeout=600)
        for p in handed:
            r = _post(f"{durl}/generate", {"tokens": p,
                                           "max_new_tokens": new})
            out["single"][tuple(p)] = r["tokens"]
            tps = (len(r["tokens"]) - 1) / (
                (r["total_ms"] - r["ttft_ms"]) / 1e3)
            _log(f"{tag}: single tier, {len(p)}-token prompt on D: TTFT "
                 f"{r['ttft_ms']:.1f} ms, decode {tps:.1f} tokens/s; "
                 f"{card}")
        D.clear_prefix_cache()           # idle: no request in flight
        with contextlib.ExitStack() as stack:
            for ctx in (_path_shapes(seen), _first_rows_call(D, resume),
                        _timed(P, "export_prefix_for", calls["export"],
                               sync=True),
                        _timed(srv, "encode_export", calls["encode"]),
                        _timed(srv, "decode_export", calls["decode"]),
                        _timed(D, "import_prefix", calls["import"],
                               sync=True),
                        _timed(D, "_retire", calls["retire"])):
                stack.enter_context(ctx)
            _zero_launches()
            for p in handed:
                _handoff_one(p, purl, durl, D, calls, out, tag, card, new)
            launches = _read_launches()
        code, body = _post_raw(f"{purl}/prefill", json.dumps(
            {"tokens": short, "max_new_tokens": new}).encode())
        err = json.loads(body).get("error")
        if code != 409 or not isinstance(err, dict) or \
                err.get("type") != "handoff_ineligible":
            raise AssertionError(f"{tag}: /prefill of {len(short)} tokens "
                                 f"gave {code} {body[:200]!r}, the typed "
                                 f"409 expected")
    finally:
        for model, httpd, th, _ in servers:
            httpd.shutdown()
            model.shutdown()
            th.join(timeout=30)
    for name, e in (("P", P), ("D", D)):
        held = sum(len(p) for p in e._prefix_index.payloads())
        if e.blocks_used() != held:
            raise AssertionError(f"{tag}: {name} holds {e.blocks_used()} "
                                 f"blocks, its resident entries {held}")
    _log(f"{tag}: /prefill of the {len(short)}-token prompt: typed 409 "
         f"handoff_ineligible; blocks held after the leg: P "
         f"{P.blocks_used()}, D {D.blocks_used()}, each its resident "
         f"entries'; launches {launches}")
    if not (launches["paged_attention"] > 0
            and launches["paged_attention_rows"]
            + launches["paged_attention_rows_mma"] > 0):
        raise AssertionError(f"{tag}: K1's decode or multi-row body never "
                             f"launched: {launches}")
    _check_path_shapes(seen, tag, dev=D.device)
    # K1 on the imported blocks: the first resume chunk's inputs, D's
    # own pools, the trash block refilled with 100.0 (decode bursts
    # write dead slots' rows there).
    _fill_trash(D)
    i, table, qh, lengths, span = resume[0]
    c = D.cache
    sb = -(-(span or (table.shape[1] - 1) * D.kv_block) // D.kv_block)
    err = _paged_err(f"{tag} K1 resume over imported blocks", dict(
        q=qh, k_pool=c["k"], v_pool=c["v"], k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"), table=table, lengths=lengths, layer=i,
        span_blocks=sb), pa.paged_attention)
    _log(f"{tag}: K1 agrees with its plain version on D's imported blocks "
         f"at the first resume chunk (R={qh.shape[2]}, start "
         f"{int(lengths[0])}, {sb} blocks, trash block 100.0): max err "
         f"{err:.3e}")
    del resume
    torch.cuda.empty_cache()
    return dict(launches=launches, **out)


def _handoff_one(p, purl, durl, D, calls, out, tag, card, new) -> None:
    """One prompt through ``/prefill`` on P, then ``/handoff`` on D,
    blocking and streamed; see :func:`_handoff_leg`."""
    t0 = time.perf_counter()
    code, body = _post_raw(f"{purl}/prefill", json.dumps(
        {"tokens": p, "max_new_tokens": new}).encode())
    pre_ms = (time.perf_counter() - t0) * 1e3
    if code != 200:
        raise AssertionError(f"{tag}: /prefill {code}: {body[:300]!r}")
    pre = json.loads(body)
    committed = pre["committed"]
    want = out["single"][tuple(p)]
    if committed != want[:1] or pre["export"]["cached_len"] != 512:
        raise AssertionError(
            f"{tag}: /prefill committed {committed} over "
            f"{pre['export']['cached_len']} rows; the single tier's first "
            f"token {want[:1]} over 512 expected")
    exp_ms, _, exp = calls["export"][-1]
    _log(f"{tag}: {len(p)}-token prompt, /prefill on P: wall {pre_ms:.1f} "
         f"ms (TTFT {pre['ttft_ms']:.1f} ms), export {exp_ms:.1f} ms, "
         f"encode {calls['encode'][-1][0]:.1f} ms, wire "
         f"{len(body) / 2 ** 20:.1f} MiB ("
         + ", ".join(f"{n} {v.dtype}{list(v.shape)}"
                     for n, v in exp["tensors"].items()) + f"); {card}")
    for mode in ("blocking", "stream"):
        D.clear_prefix_cache()
        hits, n_ret = D.prefix_hits, len(calls["retire"])
        hbody = json.dumps({"tokens": p, "committed": committed,
                            "export": pre["export"], "max_new_tokens": new,
                            "stream": mode == "stream"}).encode()
        t0 = time.perf_counter()
        first_ms = None
        if mode == "stream":
            toks, done, first_ms, decode_ms = _stream_timed(
                f"{durl}/handoff", hbody, len(committed))
            ttft = done["ttft_ms"]
            if toks[:len(committed)] != committed or \
                    done["n_tokens"] != len(toks):
                raise AssertionError(f"{tag}: the stream did not start "
                                     f"with the committed token or its "
                                     f"done line miscounts")
        else:
            code, rb = _post_raw(f"{durl}/handoff", hbody)
            if code != 200:
                raise AssertionError(f"{tag}: /handoff {code}: "
                                     f"{rb[:300]!r}")
            r = json.loads(rb)
            toks, ttft = r["tokens"], r["ttft_ms"]
            decode_ms = r["total_ms"] - ttft
        wall = (time.perf_counter() - t0) * 1e3
        out[mode][tuple(p)] = toks
        req = next(a[0] for _, a, _ in calls["retire"][n_ret:]
                   if a[0].prompt == p)
        dec_ms = calls["decode"][-1][0]
        imp_ms, _, imp_rows = calls["import"][-1]
        # After D's first token, as the single tier's rate is read.
        tps = (len(toks) - len(committed) - 1) / (decode_ms / 1e3)
        _log(f"{tag}: {len(p)}-token prompt, /handoff {mode} on D: "
             f"decode+import {dec_ms + imp_ms:.1f} ms (decode_export "
             f"{dec_ms:.1f}, import {imp_ms:.1f}: {imp_rows} rows), TTFT "
             f"on D {ttft:.1f} ms (from the parsed request)"
             + (f", first streamed decode token at {first_ms:.1f} ms"
                if first_ms is not None else "")
             + f", decode {tps:.1f} tokens/s, wall {wall:.1f} ms; {card}")
        if (imp_rows, req.resumed_len, D.prefix_hits - hits) != (512, 512,
                                                                 1) \
                or len(toks) != new:
            raise AssertionError(
                f"{tag}: {mode} handoff of {len(p)} tokens: import "
                f"{imp_rows} rows, resumed_len {req.resumed_len}, D's "
                f"prefix hits +{D.prefix_hits - hits}, {len(toks)} tokens "
                f"(512, 512, +1 and {new} expected)")


def _plain_tier(params, cfg, dev, max_len: int, **kw):
    """A one-slot plain-attention engine shaped like a tier: the
    reference whose logits hold a leg's divergences."""
    from skypilot_tpu_torch.infer import engine as eng
    return eng.InferenceEngine(
        params, cfg, n_slots=1, max_len=max_len,
        prompt_buckets=tuple(sorted({128, 512, max_len})), kv_block=256,
        prefill_chunk=512, device=dev, plain_attention=True, **kw)


def _free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_handoff(dev, card: str) -> dict:
    """The cross-replica KV handoff (:func:`_handoff_leg`) at llama3-8b:
    bf16 at full depth (16 slots, max_len 1024), the int8 recipe at full
    depth (``--kv-int8 --weights-int8``, 32 slots, max_len 1280, the
    weights quantized once and shared by both tiers) and float32 on the
    first 8 layers. Two-tier tokens are held to the single tier's: in
    float32 equal wherever the plain top-2 gap exceeds 1e-2; in bf16 and
    int8 the gap is read from the plain path on the weights in float32
    (the int8 recipe's float32 embedding beside the same int8 weights)
    and the floor raised to the bf16 noise on that context, and on the
    int8 recipe to w8a8's (:func:`_agree`). Returns {path: launches}."""
    import torch
    from skypilot_tpu_torch.infer import kvcache
    from skypilot_tpu_torch.models import llama
    config = "llama3-8b"
    cfg = llama.CONFIGS[config]

    def weights(c):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        return llama.init_params(c, gen, device=dev, dtype=c.dtype)

    def modes(leg):
        return [(f"single-tier and two-tier ({m}) tokens", leg[m])
                for m in ("blocking", "stream")]

    def wgmma_only(leg, tag):
        n = leg["launches"]
        if not n["paged_attention_rows"] or n["paged_attention_rows_mma"]:
            raise AssertionError(f"{tag}: the wgmma multi-row body "
                                 f"launched {n['paged_attention_rows']} "
                                 f"times (> 0 expected), the mma.sync one "
                                 f"{n['paged_attention_rows_mma']} (0)")

    # bf16, full depth, the serve phase's engine settings.
    t0 = time.time()
    params = weights(cfg)
    P, D = _tiers(params, cfg, dev, 16, 1024)
    _log(f"handoff: llama3-8b bf16 tiers P and D on one params tree in "
         f"{time.time() - t0:.1f} s")
    bf16 = _handoff_leg(P, D, "handoff", card)
    wgmma_only(bf16, "handoff")
    del P, D, params
    _free_card()
    _bf16_divergence(dev, config, 512, bf16["single"], modes(bf16),
                     leg="handoff")
    _free_card()

    # The int8 recipe, full depth: quantized once, shared by P and D.
    t0 = time.time()
    params = weights(cfg)
    w8 = {"blocks": kvcache.quantize_block_weights(params),
          "head": kvcache.quantize_head(params, cfg)}
    slim = kvcache.slim_params(params)
    del params
    _free_card()
    P, D = _tiers(slim, cfg, dev, 32, 1280, kv_int8=True, qweights=w8)
    _log(f"handoff[int8]: llama3-8b w8a8 + int8 KV tiers on one int8 tree "
         f"in {time.time() - t0:.1f} s")
    int8 = _handoff_leg(P, D, "handoff[int8]", card)
    wgmma_only(int8, "handoff[int8]")
    del P, D
    _free_card()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = _plain_tier({k: v.float() if torch.is_tensor(v) else
                       {n: w.float() for n, w in v.items()}
                       for k, v in slim.items()}, cfg32, dev, 1280,
                      kv_int8=True, qweights=w8)
    low = _plain_tier(slim, cfg, dev, 1280, kv_int8=True, qweights=w8)
    for paths, got in modes(int8):
        for i, (p, want) in enumerate(int8["single"].items()):
            _agree(ref, list(p), got[p], want, f"prompt {i}", paths,
                   "handoff[int8]", low=low)
    del ref, low, slim, w8
    _free_card()

    # float32, the first 8 layers at full width.
    cfg8 = dataclasses.replace(cfg, dtype=torch.float32,
                               n_layers=INT8_FP32_LAYERS)
    params = weights(cfg8)
    P, D = _tiers(params, cfg8, dev, 16, 1024)
    fp32 = _handoff_leg(P, D, "handoff[fp32]", card)
    n = fp32["launches"]
    if not n["paged_attention_rows_mma"] or n["paged_attention_rows"]:
        raise AssertionError(f"handoff[fp32]: float32 pools ran the wgmma "
                             f"body or never the mma.sync one: {n}")
    del P, D
    ref = _plain_tier(params, cfg8, dev, 1024)
    for paths, got in modes(fp32):
        for i, (p, want) in enumerate(fp32["single"].items()):
            _agree(ref, list(p), got[p], want, f"prompt {i}", paths,
                   "handoff[fp32]")
    del ref, params
    _free_card()
    return {"handoff": bf16["launches"],
            "handoff[int8]": int8["launches"],
            "handoff[fp32]": fp32["launches"]}


def phase_train(dev, card: str):
    """Returns {kernel: launches} over the llama3-1b run."""
    import os
    import shutil
    import tempfile

    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import checkpoints

    # 1. Gradient parity. In fp32 both paths differ only in how
    # attention orders its fp32 arithmetic (online softmax and per-tile
    # sums in the kernels, a full softmax and einsums in the reference),
    # about 1e-6 relative per attention output; two layers and the loss
    # carry it to ~1e-5 at most. Held to 1e-5 relative on the loss and
    # 1e-4 of max|plain| per parameter gradient. bf16 is reported, as in
    # the serve phase: a flipped bf16 rounding there is not an error
    # (and the einsum reference rounds its bf16 scores).
    par = _grad_parity(dev, torch.float32)
    worst = max(par["grad_rel"].items(), key=lambda kv: kv[1])
    dl = abs(par["loss_kernel"] - par["loss_plain"]) / abs(par["loss_plain"])
    _log(f"train[fp32 parity]: loss kernel {par['loss_kernel']:.7f} plain "
         f"{par['loss_plain']:.7f} (rel {dl:.2e}); worst grad {worst[0]} "
         f"max|diff|/max|plain| {worst[1]:.2e}")
    if not dl <= 1e-5 or not worst[1] <= 1e-4:
        raise AssertionError(f"fp32 gradient parity failed: loss rel {dl}, "
                             f"grads {par['grad_rel']}")
    par = _grad_parity(dev, torch.bfloat16)
    worst = max(par["grad_rel"].items(), key=lambda kv: kv[1])
    _log(f"train[bf16 parity, reported]: loss kernel "
         f"{par['loss_kernel']:.6f} plain {par['loss_plain']:.6f}; worst "
         f"grad {worst[0]} max|diff|/max|plain| {worst[1]:.2e}")
    del par
    gc.collect()
    torch.cuda.empty_cache()

    # 2. The main path: llama3-1b at full width and depth.
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for f in kernels:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    steps = 6
    res = _run_main(["--config", "llama3-1b", "--steps", str(steps),
                     "--log-every", "1", "--xent-chunk", "512"])
    launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = res["losses"]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"llama3-1b losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"llama3-1b loss did not fall on a repeated "
                             f"batch: {losses}")
    per_step = {n: c / steps for n, c in launches.items()}
    if per_step != {"flash_attention_fwd": 32, "flash_attention_bwd_dkv": 16,
                    "flash_attention_bwd_dq": 16}:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"K2 32 (forward + recompute), K3 16, K4 16")
    med = sorted(res["step_ms"][1:])[(steps - 1) // 2]
    _log(f"train: llama3-1b batch 4 x 2048, {steps} steps, losses "
         f"{[round(x, 4) for x in losses]}; median step {med:.1f} ms "
         f"({4 * 2048 / med * 1e3:.0f} tokens/s, steps 2-{steps}); first "
         f"step {res['step_ms'][0]:.1f} ms; peak allocated "
         f"{peak / 2**30:.2f} GiB; launches per step {per_step}; {card}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    _profile_train_step(dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. Resume at llama3-tiny: 4 steps with a checkpoint every 2, then
    # step 2 restored in a fresh directory and run to 4. The kernels
    # use no atomics, so the two runs agree bit for bit.
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        common = ["--config", "llama3-tiny", "--steps", "4", "--seq", "256",
                  "--log-every", "1", "--ckpt-every", "2"]
        full = _run_main(common + ["--ckpt-dir", a])
        shutil.copytree(os.path.join(a, "2"), os.path.join(b, "2"))
        resumed = _run_main(common + ["--ckpt-dir", b, "--resume"])
        if resumed["losses"] != full["losses"][2:]:
            raise AssertionError(f"resumed losses {resumed['losses']} != "
                                 f"uninterrupted {full['losses'][2:]}")
        if not _tree_equal(checkpoints.CheckpointManager(a).restore(step=4),
                           checkpoints.CheckpointManager(b).restore(step=4)):
            raise AssertionError("the resumed run's step-4 state differs")
    _log(f"train: llama3-tiny resume from step 2 equals the uninterrupted "
         f"run (losses {resumed['losses']}; step-4 states bit-equal)")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase",
                    choices=("all", "kernels", "serve", "handoff", "bench",
                             "train"),
                    default="all")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    try:
        from skypilot_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the skypilot_tpu_torch package is missing "
              f"({e}); run from the repository root", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _log(smi)
    dev = torch.device("cuda", 0)
    # The plain versions are references: full float32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")

    t0 = time.time()
    logs = _build.build_all()
    _log(f"build: {len(_build.SOURCES)} kernels for sm_90a in "
         f"{time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in _ptxas_summary(text):
            _log(f"  {name}: {line}")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cases = {}
    if args.phase in ("all", "kernels"):
        cases = phase_kernels(dev)
        free()
    # Launches of each kernel on each main path, counted from 0 just
    # before that path runs and read just after it.
    by_path = {}
    if args.phase in ("all", "serve"):
        by_path.update(phase_serve(dev, smi))
        free()
    if args.phase in ("all", "handoff"):
        by_path.update(phase_handoff(dev, smi))
        free()
    if args.phase in ("all", "bench"):
        by_path["bench"] = phase_bench(dev, smi)
        free()
    if args.phase in ("all", "train"):
        by_path["train"] = phase_train(dev, smi)
        free()

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        counts = {path: n[name] for path, n in by_path.items() if name in n}
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": sum(counts.values()),
                 "launches_by_path": counts}
        runs = cases.get(name)
        if runs:
            head = runs[0]
            entry.update(
                max_abs_err=max(c["max_abs_err"] for c in runs),
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], tflops=head["tflops"],
                bound_share=head["bound_share"],
                vs_library=head["vs_library"], cases=runs)
        kernels.append(entry)
    if args.phase == "all":
        for k in kernels:
            if k["launches"] <= 0:
                raise AssertionError(f"kernel {k['name']} never launched "
                                     f"on a main path")
    for k in kernels:
        if any(isinstance(v, float) and not math.isfinite(v)
               for v in k.values()):
            raise AssertionError(f"non-finite number in {k}")
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
