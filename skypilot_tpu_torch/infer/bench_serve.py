"""Serving benchmark of the port: TTFT and token throughput on the card.

Counterpart of ``skypilot_tpu/infer/bench_serve.py`` for its engine,
HTTP, prefix-share, QoS (``run_qos``: WFQ fairness against FIFO,
preemption parity), adapter (``run_adapters``: mixed-adapter decode
TPOT against one adapter, greedy parity, hot-load churn) and
speculative-decoding (``run_spec``: the model drafter pipelined and
synchronous, n-gram and oracle columns), occupancy (``run_occupancy``:
paged against contiguous slots at equal KV bytes), span
(``run_span``: span-on against full-view decode) and kernel
(``run_kernel``: K1 against its plain version) sections, with
the reference's function names, defaults and report keys. Prints ONE JSON line on stdout (chatter on
stderr):

  {"metric": "serve_median_ttft", "value": ..., "unit": "ms",
   "vs_baseline": null, ..., "device": "<card name>, <power limit>"}

Usage: python -m skypilot_tpu_torch.infer.bench_serve
       [--config llama3-8b] [--requests 16] [--slots 16]
       [--new-tokens 64] [--repeats 3] [--kv-int8] [--weights-int8]
       [--engine-only | --prefix-share | --qos | --adapters | --spec
        | --flight | --occupancy | --span | --kernel | --smoke]
       [--device cpu]

Everything runs on the CUDA card. Without one it raises, unless
``--device cpu`` asks for the kernels' plain versions on the CPU;
``--config`` defaults to llama3-tiny on the CPU and llama3-400m on the
card, as in the reference. The engine's ``plain_attention`` stays off:
the bench never swaps the kernel path for the plain one.

Deliberate differences from the reference:

- No anchor. The reference compares with JetStream's Llama-2-7B figures
  taken on a TPU v6e (its ``REF_TTFT_MS``, ``REF_TOK_S`` and
  ``REF_TPOT_MS``): another model on another chip, so the port defines
  none of them. The reports keep the reference's keys, so that their
  readers find the same names, but every ratio to that anchor and every
  verdict against it is ``null``: ``vs_baseline*``,
  ``worst_run_vs_baseline_ttft``, ``regressed``, ``worst_run_regressed``,
  ``worst_run_below_1p2x`` and ``full_load.regressed``. The JSON line
  adds ``device``, the card's name and power limit.
- No load balancer. The reference's ``run_http`` puts the JAX package's
  ``serve/load_balancer.py`` in front of the model server. The port
  imports nothing of that package and does not copy the fleet code that
  is meant to drive its replicas unchanged, so its ``run_http`` sends
  the client straight to the port's server (``"transport":
  "http_streaming"``, not ``"http_lb_streaming"``).
  ``tests/test_torch_server.py`` holds the LB path against a port
  server.
- No wave padding. The port's engine dispatches each wave at its own
  size (``ROADMAP.md``, deliberate differences), so ``_build_engine``
  takes no ``pad_waves``.
- ``run_kernel``'s kernel-off leg is the engine's plain route for its
  big-cache reads (the plain version K1 is held to), not the gather:
  the port's paged engine has no gather. ``run_occupancy`` and
  ``run_span`` take no ``kv_kernel``: their paged engine reads through
  K1 always. ``run_occupancy`` counts trash rows on both sides, so its
  paged pool holds one block less than the reference's.
- Other KV blocks. The bench keeps the reference's ``max_len``
  (prompt + new tokens + 8), but on the card the engine picks the
  largest block that tiles it AND that K1's multi-row body reads
  (``engine.kv_block_len``): 8 rows at the mixed prompts' 1064, where
  the reference takes 152.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.infer import draft as draft_lib
from skypilot_tpu_torch.infer import engine as eng
from skypilot_tpu_torch.infer import kvcache
from skypilot_tpu_torch.infer import server as srv
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import flight as flight_lib

def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    """Host sync before the wall clock is read: PyTorch returns before
    the card finishes."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_kind(dev: torch.device) -> str:
    """The device a report's numbers come from: on the card, its name
    and power limit as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return str(dev)
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return lines[min(dev.index or 0, len(lines) - 1)]


def run(config=None, requests=16, slots=16, prompt_len=96,
        new_tokens=64, max_burst=32, kv_int8=False,
        weights_int8=False, admit_wave=None,
        device: DeviceLike = None) -> dict:
    """Run the serving benchmark on the engine alone (engine-internal
    TTFT); returns the metrics dict."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    cfg, e = _build_engine(config, slots, prompt_len, new_tokens,
                           kv_int8, weights_int8, max_wave=admit_wave,
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
               for _ in range(requests)]

    # Warmup: build the kernels and warm the allocator on a full wave
    # and on bursts of the measured run's own size.
    for p in [prompts[0]] * slots:
        e.add_request(p, max_new_tokens=new_tokens)
    e.run_to_completion(max_burst=max_burst)
    e.finished.clear()

    t0 = time.time()
    for p in prompts:
        e.add_request(p, max_new_tokens=new_tokens)
    done = e.run_to_completion(max_burst=max_burst)
    _sync(dev)
    wall = time.time() - t0

    ttfts = sorted((r.first_token_s - r.submit_s) * 1e3 for r in done)
    med_ttft = ttfts[len(ttfts) // 2]
    total_tokens = sum(len(r.tokens) for r in done)
    tok_s = total_tokens / wall
    req_s = len(done) / wall

    log(f"requests={len(done)} wall={wall:.2f}s median_ttft={med_ttft:.1f}ms "
        f"tok/s={tok_s:.1f} req/s={req_s:.2f}")
    return {
        "median_ttft_ms": round(med_ttft, 2),
        "out_tok_s": round(tok_s, 2),
        "req_per_s": round(req_s, 3),
        "vs_baseline_ttft": None,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
    }


def _build_engine(config, slots, prompt_len, new_tokens, kv_int8,
                  weights_int8, max_wave=None, buckets=None,
                  prefill_chunk=None, prefix_pool=None,
                  device: DeviceLike = None):
    """(cfg, engine) for ``config`` with random weights from seed 0 on
    ``device`` (None: the card, raising when there is none). Shapes are
    the reference bench's: prompt buckets ``buckets`` (default
    ``(prompt_len,)``) and ``max_len`` = prompt_len + new_tokens + 8.
    The features the bench does not set take the reference ENGINE's
    defaults, not the server's: ``prefill_chunk`` from
    SKYTPU_PREFILL_CHUNK (512), ``prefix_pool`` from SKYTPU_PREFIX_POOL
    (0) and ``spec_k`` from SKYTPU_SPEC_K (0). ``weights_int8`` draws
    int8 weights directly (``kvcache.random_quantized_params``), so no
    float 8B tree is ever built. The port's engine pads no waves, so
    there is no ``pad_waves``."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[config]
    log(f"serve bench: {config} on {_device_kind(dev)}")
    max_len = prompt_len + new_tokens + 8
    if buckets is None:
        buckets = (prompt_len,)
    if prefill_chunk is None:
        prefill_chunk = int(
            os.environ.get("SKYTPU_PREFILL_CHUNK", "512") or 0)
    if prefix_pool is None:
        prefix_pool = int(os.environ.get("SKYTPU_PREFIX_POOL", "0") or 0)
    spec_k = int(os.environ.get("SKYTPU_SPEC_K", "0") or 0)
    kw = dict(n_slots=slots, max_len=max_len, prompt_buckets=buckets,
              kv_int8=kv_int8, max_wave=max_wave,
              prefill_chunk=prefill_chunk, prefix_pool=prefix_pool,
              spec_k=spec_k, device=dev)
    if weights_int8:
        # Build int8 weights directly: the float init of an 8B-class
        # config is twice the bytes of the int8 model it serves.
        params, qw = kvcache.random_quantized_params(cfg, device=dev)
        return cfg, eng.InferenceEngine(params, cfg, qweights=qw, **kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    return cfg, eng.InferenceEngine(params, cfg, **kw)


def _mixed_prompts(rng, vocab, requests, lo=512, hi=1024):
    """Realistic prompt-length mix, every prompt >= ``lo`` tokens: half
    at exactly ``lo`` (short-bucket), half uniform in (3/4*hi, hi] —
    including full ``hi``-token prompts. Returns (prompts, buckets)."""
    lens = []
    for i in range(requests):
        if i % 2 == 0:
            lens.append(lo)
        else:
            lens.append(int(rng.integers(hi - hi // 4 + 1, hi + 1)))
    prompts = [rng.integers(1, vocab, n).tolist() for n in lens]
    return prompts, (lo, hi)


def _client_wave(host, port, payloads, timeout=600.0, stagger_s=0.0,
                 bodies=None):
    """Fire every payload concurrently from ONE thread (raw sockets +
    a selector). A thread-per-request client adds interpreter-lock
    scheduling jitter that rivals the TTFTs being measured on a host
    with few cores.

    ``stagger_s`` paces arrivals: request i is sent at i*stagger_s —
    an open-ish workload instead of one instantaneous burst, so
    admission overlaps decode the way production traffic does.

    Returns [(ttft_s, n_tokens, total_s)] aligned with payloads.
    TTFT is wall time from request send to the first BODY byte (the
    response headers go out before any token and don't count).
    ``bodies``, if a list, collects each raw response body (chunked
    framing included) in payload order. Raises AssertionError on an
    incomplete response, a non-200 status or an ``"error"`` line
    mid-stream.
    """
    import re
    import selectors
    import socket

    sel = selectors.DefaultSelector()
    conns = []
    t_start = time.time()
    unsent = []
    for i, body in enumerate(payloads):
        s = socket.create_connection((host, port))
        head = (f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        st = {"sock": s, "t0": None, "buf": b"", "first": None,
              "hdr_end": None, "done": None}
        conns.append(st)
        unsent.append((t_start + i * stagger_s, s, head + body, st))

    def send_due():
        while unsent and time.time() >= unsent[0][0]:
            _, s, data, st = unsent.pop(0)
            s.sendall(data)            # still blocking: full send
            st["t0"] = time.time()
            s.setblocking(False)
            sel.register(s, selectors.EVENT_READ, st)

    send_due()
    deadline = time.time() + timeout
    live = len(conns)
    while live and time.time() < deadline:
        wait = 1.0
        if unsent:
            wait = max(min(wait, unsent[0][0] - time.time()), 0.0)
        events = sel.select(timeout=wait)
        send_due()
        for key, _ in events:
            st = key.data
            try:
                piece = st["sock"].recv(1 << 16)
            except BlockingIOError:
                continue
            now = time.time()
            if not piece:   # server closed early — treat as done
                sel.unregister(st["sock"])
                st["done"] = st["done"] or now
                live -= 1
                continue
            st["buf"] += piece
            if st["hdr_end"] is None:
                pos = st["buf"].find(b"\r\n\r\n")
                if pos >= 0:
                    st["hdr_end"] = pos + 4
                    hdrs = st["buf"][:pos].lower()
                    # Error paths (400/500) respond with Content-Length
                    # over the same keep-alive socket — no chunked
                    # terminator, no close; completion must come from
                    # the framed length.
                    m = re.search(rb"content-length:\s*(\d+)", hdrs)
                    if m:
                        st["clen"] = int(m.group(1))
            if (st["first"] is None and st["hdr_end"] is not None
                    and len(st["buf"]) > st["hdr_end"]):
                st["first"] = now
            done = False
            if st["hdr_end"] is not None and st.get("clen") is not None:
                done = (len(st["buf"]) - st["hdr_end"] >= st["clen"])
            # Chunked body ends with the zero-length chunk.
            elif st["buf"].endswith(b"0\r\n\r\n"):
                done = True
            if done:
                sel.unregister(st["sock"])
                st["done"] = now
                live -= 1
    sel.close()
    out = []
    for st in conns:
        st["sock"].close()
        status = st["buf"].split(b"\r\n", 1)[0]
        if st["done"] is None or st["first"] is None:
            raise AssertionError(
                f"request did not complete (status line {status!r})")
        if b" 200 " not in status + b" ":
            raise AssertionError(f"non-200 response: {status!r} "
                                 f"{st['buf'][:300]!r}")
        body = st["buf"][st["hdr_end"]:]
        if re.search(rb'"error"\s*:', body):
            # A mid-stream engine failure ends the 200 stream with an
            # {"error": ...} line — counting it as a 0-token success
            # would silently corrupt the bench numbers.
            raise AssertionError(f"engine error mid-stream: "
                                 f"{body[:300]!r}")
        m = re.search(rb'"n_tokens":\s*(\d+)', st["buf"])
        n_tok = int(m.group(1)) if m else 0
        out.append((st["first"] - st["t0"], n_tok,
                    st["done"] - st["t0"]))
        if bodies is not None:
            bodies.append(body)
    return out


def run_http(config=None, requests=16, slots=16, prompt_len=None,
             new_tokens=64, max_burst=8, kv_int8=False,
             weights_int8=False, admit_wave=None, open_burst=4,
             repeats=1, prompt_lo=512, prompt_hi=1024,
             stagger_s=0.0, coalesce_s=0.012, full_load=False,
             device: DeviceLike = None) -> dict:
    """End-to-end streaming bench: requests go over HTTP to the port's
    model server (``server.serve``), and TTFT is the wall time to the
    FIRST STREAMED BYTE of each response, not an engine-internal
    timestamp. The reference routes the same client through its load
    balancer; the port has none (module docstring), so ``transport`` is
    ``"http_streaming"``.

    ``prompt_len=None`` uses a realistic length mix in
    [prompt_lo, prompt_hi] (every prompt >= prompt_lo; see
    :func:`_mixed_prompts`); an int pins every prompt to that length.
    ``repeats`` runs the timed wave N times back-to-back on the warm
    server and reports the median-of-runs AND the worst run — a
    serving number is only real if the worst run clears the bar too.
    ``full_load`` adds a phase with every slot filled.
    """
    import socket
    import threading

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    if admit_wave is None:
        # The reference's wave cap (its padded waves need one): the
        # port admits the same waves.
        admit_wave = 4

    cfg = llama.CONFIGS[config]
    rng = np.random.default_rng(0)
    if prompt_len is None:
        prompts, (lo, hi) = _mixed_prompts(rng, cfg.vocab_size,
                                           requests, prompt_lo,
                                           prompt_hi)
        if on_cpu:   # keep CPU CI fast; shape behavior is identical
            prompts = [p[:max(len(p) // 8, 4)] for p in prompts]
            lo, hi = lo // 8, hi // 8
        buckets = (lo, hi)
        max_prompt = hi
    else:
        prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
                   for _ in range(requests)]
        buckets = (prompt_len,)
        max_prompt = prompt_len
    mean_len = sum(len(p) for p in prompts) / len(prompts)

    _, engine = _build_engine(config, slots, max_prompt, new_tokens,
                              kv_int8, weights_int8,
                              max_wave=admit_wave, buckets=buckets,
                              device=dev)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    model_port = free_port()
    model, httpd = srv.serve(engine, host="127.0.0.1", port=model_port,
                             max_burst=max_burst,
                             open_burst=open_burst,
                             coalesce_s=coalesce_s)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        model.wait_ready(timeout=600)
        payloads = [json.dumps({"tokens": p, "max_new_tokens": new_tokens,
                                "stream": True}).encode()
                    for p in prompts]

        # Warmup: the same concurrent wave as the measurement — builds
        # the kernels and runs every admission shape and both decode
        # burst sizes (open_burst while slots drain in, max_burst once
        # full) outside the timed window.
        _client_wave("127.0.0.1", model_port, payloads)

        def _tpots(res):
            # Per-request TPOT: stream time after the first byte,
            # averaged over the remaining tokens (chunk-granular at the
            # burst size).
            return [(tot - ttft) / max(n - 1, 1) * 1e3
                    for (ttft, n, tot) in res if n > 1]

        runs = []
        all_ttfts = []
        all_tpots = []
        for rep in range(max(repeats, 1)):
            t0 = time.time()
            res = _client_wave("127.0.0.1", model_port, payloads,
                               stagger_s=stagger_s)
            wall = time.time() - t0
            ttfts = sorted(r[0] * 1e3 for r in res)
            all_ttfts.extend(ttfts)
            all_tpots.extend(_tpots(res))
            total_tokens = sum(r[1] for r in res)
            runs.append({
                "median_ttft_ms": round(ttfts[len(ttfts) // 2], 2),
                "max_ttft_ms": round(ttfts[-1], 2),
                "out_tok_s": round(total_tokens / wall, 2),
                "wall_s": round(wall, 3),
            })
            log(f"run {rep + 1}/{repeats}: median_ttft="
                f"{runs[-1]['median_ttft_ms']:.1f}ms "
                f"max={runs[-1]['max_ttft_ms']:.1f}ms "
                f"tok/s={runs[-1]['out_tok_s']:.1f}")

        # Second phase on the SAME warm server: every slot filled
        # (throughput-optimal load, vs the headroom load above that the
        # TTFT numbers use).
        full = None
        if full_load and requests >= slots:
            log(f"full-load phase skipped: requests ({requests}) already "
                f">= slots ({slots}) — the headline phase IS full load")
        if full_load and requests < slots:
            if prompt_len is None:
                fl_prompts, _ = _mixed_prompts(rng, cfg.vocab_size, slots,
                                               prompt_lo, prompt_hi)
                if on_cpu:
                    fl_prompts = [p[:max(len(p) // 8, 4)]
                                  for p in fl_prompts]
            else:
                # Pinned-length benches must stay inside the engine's
                # buckets — the mixed draw would exceed max_prompt.
                fl_prompts = [rng.integers(1, cfg.vocab_size,
                                           prompt_len).tolist()
                              for _ in range(slots)]
            fl_payloads = [json.dumps({"tokens": p,
                                       "max_new_tokens": new_tokens,
                                       "stream": True}).encode()
                           for p in fl_prompts]
            _client_wave("127.0.0.1", model_port, fl_payloads)  # warm
            fl_runs = []
            fl_tpots = []
            for rep in range(3):
                t0 = time.time()
                res = _client_wave("127.0.0.1", model_port, fl_payloads)
                wall = time.time() - t0
                ttfts = sorted(r[0] * 1e3 for r in res)
                fl_tpots.extend(_tpots(res))
                fl_runs.append({
                    "median_ttft_ms": round(ttfts[len(ttfts) // 2], 2),
                    "out_tok_s": round(sum(r[1] for r in res) / wall, 2),
                    "wall_s": round(wall, 3),
                })
                log(f"full-load run {rep + 1}/3: "
                    f"median_ttft={fl_runs[-1]['median_ttft_ms']:.1f}ms "
                    f"tok/s={fl_runs[-1]['out_tok_s']:.1f}")
            # Median across runs — same reporting discipline as the
            # headline phase (a lucky run must not become the record).
            toks_sorted = sorted(r["out_tok_s"] for r in fl_runs)
            ttft_sorted = sorted(r["median_ttft_ms"] for r in fl_runs)
            fl_tpots.sort()
            full = {
                "requests": slots,
                "out_tok_s": toks_sorted[len(toks_sorted) // 2],
                "median_ttft_ms": ttft_sorted[len(ttft_sorted) // 2],
                "tpot_ms": (round(fl_tpots[len(fl_tpots) // 2], 2)
                            if fl_tpots else None),
                "regressed": None,
                "runs": fl_runs,
            }
    finally:
        httpd.shutdown()
        httpd.server_close()
        model.shutdown()

    medians = sorted(r["median_ttft_ms"] for r in runs)
    med_ttft = medians[len(medians) // 2]
    worst_ttft = medians[-1]
    all_ttfts.sort()
    p99_ttft = all_ttfts[min(len(all_ttfts) - 1,
                             int(len(all_ttfts) * 0.99))]
    toks = sorted(r["out_tok_s"] for r in runs)
    tok_s = toks[len(toks) // 2]
    wall_total = sum(r["wall_s"] for r in runs)
    req_s = requests * len(runs) / wall_total
    all_tpots.sort()
    tpot = all_tpots[len(all_tpots) // 2] if all_tpots else None
    log(f"http streaming x{len(runs)}: median-of-runs "
        f"{med_ttft:.1f}ms worst-run {worst_ttft:.1f}ms "
        f"p99(all) {p99_ttft:.1f}ms tok/s {tok_s:.1f} "
        f"tpot {tpot if tpot is None else round(tpot, 2)}ms")
    return {
        "median_ttft_ms": round(med_ttft, 2),
        "worst_run_median_ttft_ms": round(worst_ttft, 2),
        "p99_ttft_ms": round(p99_ttft, 2),
        "out_tok_s": round(tok_s, 2),
        "req_per_s": round(req_s, 3),
        "tpot_ms": round(tpot, 2) if tpot is not None else None,
        "vs_baseline_tpot": None,
        "vs_baseline_ttft": None,
        "worst_run_vs_baseline_ttft": None,
        "worst_run_below_1p2x": None,
        "regressed": None,
        "worst_run_regressed": None,
        "runs": runs,
        "prompt_mean_len": round(mean_len, 1),
        "prompt_max_len": max(len(p) for p in prompts),
        "new_tokens": new_tokens,
        "stagger_s": stagger_s,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
        "transport": "http_streaming",
        **({"full_load": full} if full else {}),
    }


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _p99(xs):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * 0.99))] if xs else None


def _interference(engine, fillers, longs, burst, idle_bursts=8):
    """Decode-interference report: per-token decode cadence while long
    prompts are being admitted vs idle decode.

    ``fillers`` (short prompts, long generations) occupy slots and keep
    decoding; once steady, ``longs`` (long prompts) are injected and
    the scheduler runs the server's alternation (one prefill chunk —
    or, chunk-disabled, the whole monolith wave — between decode
    bursts). TPOT here is the REQUEST-experienced cadence: the wall
    interval between consecutive burst completions divided by the burst
    size, so time decode spent stalled behind prefill is charged to it.
    Each burst fetches its tokens, so every interval ends on a host
    sync. Returns stats in ms plus the admission-vs-idle p99 ratio.
    """
    for p in fillers:
        engine.add_request(p, max_new_tokens=engine.max_len)
    engine.admit()
    engine.decode_burst(burst)            # warm the cadence
    idle = []
    for _ in range(idle_bursts):
        t0 = time.time()
        engine.decode_burst(burst)
        idle.append(time.time() - t0)
    for p in longs:
        engine.add_request(p, max_new_tokens=4)
    intervals, stalls = [], []
    t_last = time.time()
    while engine.waiting or engine.chunking:
        engine.admit()
        if engine.chunking:
            t0 = time.time()
            engine.prefill_chunk_step()
            stalls.append(time.time() - t0)
        engine.decode_burst(burst)
        now = time.time()
        intervals.append(now - t_last)
        t_last = now
    # Drain and reset so the caller gets a quiet engine back.
    engine.reset()
    idle_tpot = _median(idle) / burst * 1e3
    adm_p99 = (_p99(intervals) / burst * 1e3 if intervals
               else idle_tpot)
    return {
        "idle_tpot_ms": round(idle_tpot, 3),
        "admission_tpot_p99_ms": round(adm_p99, 3),
        "tpot_admission_ratio": round(adm_p99 / max(idle_tpot, 1e-9),
                                      3),
        "decode_stall_p99_ms": (round(_p99(stalls) * 1e3, 3)
                                if stalls else 0.0),
        "admission_bursts": len(intervals),
    }


def run_prefix_share(config=None, requests=12, slots=16,
                     system_len=None, tail_len=None, new_tokens=None,
                     max_burst=16, prefill_chunk=None, prefix_pool=8,
                     kv_int8=False, weights_int8=False,
                     smoke=False, device: DeviceLike = None) -> dict:
    """Prefix-share workload: every prompt = one shared system prompt +
    a unique tail (the dominant production shape). Measures cold
    (empty prefix cache) vs warm (system prompt resident) TTFT on the
    same engine, checks greedy token parity between the two passes,
    and appends the decode-interference report (chunked scheduler vs
    the per-bucket monolith). ``smoke=True`` shrinks everything to a
    CPU-CI-sized regression guard (run_smoke)."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    if system_len is None:
        system_len = 24 if small else 768
    if tail_len is None:
        tail_len = 6 if small else 48
    if new_tokens is None:
        new_tokens = 6 if small else 48
    if prefill_chunk is None:
        prefill_chunk = 8 if small else 256
    if small:
        requests = min(requests, 4)
        slots = min(slots, 4)
        max_burst = min(max_burst, 4)
        prefix_pool = min(prefix_pool, 4)
    requests = min(requests, slots)   # one admission pass => all cold
    bucket = system_len + tail_len
    short_bucket = min(32, bucket)
    # Row headroom so the interference phase's filler requests never
    # push the burst cap below the measured burst size.
    iburst = min(max_burst, 4 if small else 8)
    headroom = 48 if small else 0
    cfg, e = _build_engine(config, slots, bucket,
                           new_tokens + headroom, kv_int8,
                           weights_int8, buckets=(short_bucket, bucket),
                           prefill_chunk=prefill_chunk,
                           prefix_pool=prefix_pool, device=dev)
    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, system_len).tolist()

    def make_prompts(salt):
        return [system + rng.integers(1, cfg.vocab_size,
                                      tail_len).tolist()
                for _ in range(requests)]

    prompts = make_prompts(0)

    # Warmup: build the kernels and run the claim, chunk, prefix-store
    # and decode paths (first request, cold) AND the prefix-hit path
    # (second, identical request hits the prefix just stored).
    e.add_request(prompts[0], max_new_tokens=2)
    e.run_to_completion(max_burst=max_burst)
    e.add_request(prompts[0], max_new_tokens=2)
    e.run_to_completion(max_burst=max_burst)
    e.finished.clear()
    e.clear_prefix_cache()

    def timed_pass(ps):
        for p in ps:
            e.add_request(p, max_new_tokens=new_tokens)
        done = e.run_to_completion(max_burst=max_burst)
        _sync(dev)
        ttfts = [(r.first_token_s - r.submit_s) * 1e3 for r in done]
        out = {tuple(r.prompt): list(r.tokens) for r in done}
        hits = sum(1 for r in done if r.cached_len > 0)
        chunks = sum(r.n_chunks for r in done)
        e.finished.clear()
        return _median(ttfts), out, hits, chunks

    cold_ttft, cold_out, cold_hits, cold_chunks = timed_pass(prompts)
    warm_ttft, warm_out, warm_hits, warm_chunks = timed_pass(prompts)
    parity_ok = all(warm_out[k] == cold_out[k] for k in cold_out)

    log(f"prefix-share: cold={cold_ttft:.1f}ms warm={warm_ttft:.1f}ms "
        f"hits {warm_hits}/{requests} parity={parity_ok}")

    n_f = max(slots // 2, 1)
    fillers = [rng.integers(1, cfg.vocab_size, 4).tolist()
               for _ in range(n_f)]
    longs = [rng.integers(1, cfg.vocab_size, bucket).tolist()
             for _ in range(min(slots - n_f, n_f, 4))]
    interference = _interference(e, fillers, longs, burst=iburst,
                                 idle_bursts=4 if small else 8)
    # Free the chunked engine BEFORE building the monolith comparison:
    # two 8B-class bf16 weight sets (16 GB each) must not be resident at
    # once.
    del e, timed_pass          # timed_pass's closure also pins the engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # The same workload against the per-bucket monolith: the
    # interference chunked prefill removes.
    _, e_mono = _build_engine(config, slots, bucket,
                              new_tokens + headroom, kv_int8,
                              weights_int8,
                              buckets=(short_bucket, bucket),
                              prefill_chunk=0, prefix_pool=0, device=dev)
    # Run the exact wave shapes the measured window will admit once
    # before it.
    for p in longs:
        e_mono.add_request(p, max_new_tokens=2)
    e_mono.run_to_completion(max_burst=iburst)
    e_mono.generate([fillers[0]], max_new_tokens=2)
    e_mono.finished.clear()
    mono = _interference(e_mono, fillers, longs, burst=iburst,
                         idle_bursts=4 if small else 8)
    interference["monolith_tpot_p99_ms"] = mono["admission_tpot_p99_ms"]
    interference["monolith_ratio"] = mono["tpot_admission_ratio"]
    log(f"interference: idle {interference['idle_tpot_ms']}ms/tok, "
        f"admission p99 {interference['admission_tpot_p99_ms']} "
        f"(x{interference['tpot_admission_ratio']}), monolith "
        f"x{interference['monolith_ratio']}")

    return {
        "cold_ttft_ms": round(cold_ttft, 2),
        "warm_ttft_ms": round(warm_ttft, 2),
        "warm_speedup": round(cold_ttft / max(warm_ttft, 1e-9), 3),
        # Acceptance bar: warm-prefix median TTFT >= 30% below cold.
        "warm_below_70pct_of_cold": bool(warm_ttft <= 0.7 * cold_ttft),
        "hit_rate": round(warm_hits / max(requests, 1), 3),
        "cold_hits": cold_hits,
        "parity_ok": bool(parity_ok),
        "prefix_hits": warm_hits,
        # Structural (timing-independent) evidence of reuse: chunk
        # programs run per pass — the warm pass prefills suffixes only.
        "cold_chunks": cold_chunks,
        "warm_chunks": warm_chunks,
        "decode_stall_p99_ms": interference["decode_stall_p99_ms"],
        "interference": interference,
        "requests": requests,
        "system_len": system_len,
        "tail_len": tail_len,
        "prefill_chunk": prefill_chunk,
        "prefix_pool": prefix_pool,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
    }


def run_qos(config=None, slots=None, bg_requests=None,
            hot_requests=None, new_tokens=None, max_burst=8,
            kv_int8=False, weights_int8=False, smoke=False,
            device: DeviceLike = None, tokens_out=None) -> dict:
    """Multi-tenant QoS bench: weighted-fair-queueing isolation under a
    hot tenant, and preemption-by-eviction greedy parity.

    1. **Fairness**: a background tenant's requests run (a) alone
       (idle), (b) behind a hot tenant's flood under WFQ, and (c) the
       same flood under plain FIFO (the control). The reference's
       docstring gates (background TPOT p99 under contention <= 1.3x
       idle; WFQ admits the background tenant ahead of the flood while
       FIFO strands it, ``bg_ttft_fifo_ratio``) were set on a TPU; here
       they are reported, not targets.
    2. **Preemption parity**: a low-priority request is evicted
       mid-decode by a high-priority arrival (one-slot engine), resumes
       warm from the prefix cache, and must give its unpreempted run's
       greedy tokens, over {fp32 KV, int8 KV} x {spec 0, 4}
       (``smoke=True``, or ``kv_int8``, runs that dtype's spec pair).
       Zero leaked blocks after retire + cache clear is asserted.

    The reference's names, defaults and report keys; on the CPU (or
    ``smoke``) the sizes shrink as the reference's do. Every engine
    shares one weight tree (random, seed 0), as the reference's rebuilds
    from one key do, and the reference's pool size (one max_len row of
    blocks per slot and one spare). ``tokens_out``, a dict, receives the
    token lists behind the two parity verdicts: ``"sched"`` (background
    prompts; idle, WFQ and FIFO tokens) and ``"preempt"`` ([(spec_k,
    kv_int8, prompt, unpreempted, preempted)]), so that a caller can
    hold a bf16 divergence to its own rule."""
    from skypilot_tpu_torch.infer import qos as qos_lib
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    slots = slots or (4 if small else 8)
    bg_requests = bg_requests or 2
    hot_requests = hot_requests or (3 * slots)
    new_tokens = new_tokens or (16 if small else 64)
    prompt_len = 12
    max_len = 64 if small else 256
    cfg = llama.CONFIGS[config]
    log(f"qos bench: {config} on {_device_kind(dev)} slots={slots} "
        f"bg={bg_requests} hot={hot_requests} new_tokens={new_tokens}")
    if weights_int8:
        params, qw = kvcache.random_quantized_params(cfg, device=dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
        qw = None
    block = eng.kv_block_len(max_len, 256, dev.type == "cuda")

    def build(n_slots, qos=None, spec_k=0, chunk=0, pool=0,
              buckets=None, kv_int8=kv_int8):
        return eng.InferenceEngine(
            params, cfg, n_slots=n_slots, max_len=max_len,
            prompt_buckets=buckets or (prompt_len,), kv_int8=kv_int8,
            prefill_chunk=chunk, prefix_pool=pool, max_wave=n_slots,
            spec_k=spec_k, qos=qos, qweights=qw,
            kv_blocks=(n_slots + 1) * (max_len // block), device=dev)

    rng = np.random.default_rng(0)
    bg_prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
                  for _ in range(bg_requests)]
    hot_prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
                   for _ in range(hot_requests)]

    def fairness_pass(e, with_hot):
        """Hot flood enqueued FIRST (worst case for the background
        tenant), then background; per-background-request TTFT and TPOT
        collected at retirement."""
        ids = []
        if with_hot:
            for p in hot_prompts:
                e.add_request(p, max_new_tokens=new_tokens, tenant="hot")
        for p in bg_prompts:
            ids.append(e.add_request(p, max_new_tokens=new_tokens,
                                     tenant="background"))
        done_s: dict = {}
        while e.waiting or e.chunking or e.slot_req:
            e.step_burst(max_burst)
            _sync(dev)
            now = time.time()
            for r in e.finished:
                done_s.setdefault(r.rid, now)
        by_rid = {r.rid: r for r in e.finished}
        ttfts, tpots = [], []
        for rid in ids:
            r = by_rid[rid]
            ttfts.append(r.first_token_s - r.submit_s)
            if len(r.tokens) > 1:
                tpots.append((done_s[rid] - r.first_token_s)
                             / (len(r.tokens) - 1))
        outs = [by_rid[i].tokens for i in ids]
        e.finished.clear()
        return ttfts, tpots, outs

    # Warmup (kernel builds, allocator), then idle / WFQ-contended /
    # FIFO-contended on fresh schedulers.
    e = build(slots, qos=qos_lib.FairScheduler())
    fairness_pass(e, with_hot=False)
    idle_ttft, idle_tpot, idle_out = fairness_pass(e, with_hot=False)
    e.qos = qos_lib.FairScheduler()
    wfq_ttft, wfq_tpot, wfq_out = fairness_pass(e, with_hot=True)
    e.qos = None
    fifo_ttft, _fifo_tpot, fifo_out = fairness_pass(e, with_hot=True)
    del e
    if tokens_out is not None:
        tokens_out["sched"] = (bg_prompts, idle_out, wfq_out, fifo_out)

    # Scheduling must never change tokens: same engine, same greedy
    # stream per request.
    sched_parity = (idle_out == wfq_out == fifo_out)
    fairness_ratio = _p99(wfq_tpot) / max(_p99(idle_tpot), 1e-9)
    ttft_wfq_ratio = _p99(wfq_ttft) / max(_p99(idle_ttft), 1e-9)
    ttft_fifo_ratio = _p99(fifo_ttft) / max(_p99(idle_ttft), 1e-9)
    log(f"qos fairness: bg TPOT p99 x{fairness_ratio:.2f} vs idle "
        f"(bg TTFT p99 x{ttft_wfq_ratio:.1f} wfq / "
        f"x{ttft_fifo_ratio:.1f} fifo), sched parity={sched_parity}")

    # Phase 2: preemption-by-eviction parity on one-slot engines,
    # chunked prefill + prefix cache on (the warm-resume path).
    dtypes = [kv_int8] if (smoke or kv_int8) else [False, True]
    combos = [(k, i8) for i8 in dtypes for k in (0, 4)]
    parity_ok = True
    preemptions = 0
    resumed_rows = 0
    low_prompt = list(range(5, 5 + prompt_len))
    hi_prompt = [3, 1, 4]
    preempt_tokens = []
    for spec_k, i8 in combos:
        ref = build(1, chunk=8, pool=4, spec_k=spec_k, kv_int8=i8,
                    buckets=(prompt_len + new_tokens + 8,))
        want = ref.generate([low_prompt], max_new_tokens=new_tokens)[0]
        del ref
        e2 = build(1, qos=qos_lib.FairScheduler(), chunk=8, pool=4,
                   spec_k=spec_k, kv_int8=i8,
                   buckets=(prompt_len + new_tokens + 8,))
        rid_low = e2.add_request(low_prompt, max_new_tokens=new_tokens,
                                 priority=0)
        while not e2.slot_req:
            e2.step_burst(max_burst=2)
        for _ in range(2):
            e2.decode_burst(max_burst=2)
        e2.add_request(hi_prompt, max_new_tokens=4, priority=1)
        e2.run_to_completion(max_burst=2)
        by_rid = {r.rid: r for r in e2.finished}
        low = by_rid[rid_low]
        parity_ok = parity_ok and (low.tokens == want
                                   and low.preemptions >= 1)
        preemptions += low.preemptions
        resumed_rows += low.resumed_len
        preempt_tokens.append((spec_k, i8, low_prompt, want, low.tokens))
        e2.clear_prefix_cache()
        assert e2.allocator.used == 0, (
            f"block leak after preemption cycle: {e2.allocator.used}")
        del e2
    if tokens_out is not None:
        tokens_out["preempt"] = preempt_tokens
    log(f"qos preempt: parity={parity_ok} preemptions={preemptions} "
        f"resumed_rows={resumed_rows}")
    del params, qw
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    return {
        "fairness_ratio": round(fairness_ratio, 3),
        "bg_tpot_idle_p99_ms": round(_p99(idle_tpot) * 1e3, 3),
        "bg_tpot_contended_p99_ms": round(_p99(wfq_tpot) * 1e3, 3),
        "bg_ttft_wfq_ratio": round(ttft_wfq_ratio, 3),
        "bg_ttft_fifo_ratio": round(ttft_fifo_ratio, 3),
        "sched_parity_ok": bool(sched_parity),
        "preempt_parity_ok": bool(parity_ok),
        "preemptions": int(preemptions),
        "preempt_resumed_rows": int(resumed_rows),
        "slots": slots,
        "bg_requests": bg_requests,
        "hot_requests": hot_requests,
        "new_tokens": new_tokens,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
    }


def adapter_tree(cfg, rank: int, seed: int) -> dict:
    """The bench's fine-tune ``seed``: a random rank-``rank`` adapter
    tree (normal * 0.02, from numpy seed ``seed``), registered at the
    default alpha (32)."""
    from skypilot_tpu_torch.infer import adapters as ad_lib
    r = np.random.default_rng(seed)
    L = cfg.n_layers
    return {t: {"a": r.normal(size=(L,) + sa).astype(np.float32) * 0.02,
                "b": r.normal(size=(L,) + sb).astype(np.float32) * 0.02}
            for t, (sa, sb) in ad_lib.target_shapes(cfg, rank).items()}


def run_adapters(config=None, n_adapters=8, requests=None,
                 prompt_len=None, new_tokens=None, max_burst=8,
                 kv_int8=False, weights_int8=False, spec_k=0,
                 smoke=False, device: DeviceLike = None,
                 tokens_out=None) -> dict:
    """Multi-LoRA adapter-catalog bench: N-adapters-vs-1 decode TPOT
    overhead on the SAME engine.

    Three phases, one engine:

    1. BASELINE — every request generates under ONE fine-tune (decode
       gathers one pool slot's (A, B) per layer).
    2. MIXED — the same requests spread over ``n_adapters`` fine-tunes
       in one continuous batch. The gather indexes differ; the code is
       the same (the adapter id is slot data), so the overhead is the
       gather's cost (the reference's hardware gate is
       ``overhead_ratio`` <= 1.15; reported here, not a target). Greedy
       parity is checked against per-request sequential runs.
    3. HOT-LOAD CHURN — twice the pool's fine-tunes cycle through
       traffic: every demand load is an LRU evict + install. The
       engine warmed its programs and armed the compile watch first, so
       ``unexpected_compiles`` counts any key the churn dispatched that
       the warm-up did not; the pool's tensors must also keep their
       addresses (installs write in place).

    ``smoke=True`` / CPU: CI-sized (rank 4, ``n_adapters`` requests of
    16 tokens, 32 new, max_len 256); else rank 16, ``2 * n_adapters``
    requests of 128 tokens, 256 new, max_len 2048. Random weights from
    seed 0 (``weights_int8``: ``kvcache.random_quantized_params``), the
    fine-tunes from :func:`adapter_tree` with seeds 100, 101, ...
    ``tokens_out``, a dict, receives ``"parity"``: [(prompt, adapter,
    mixed tokens, sequential tokens)], so that a caller can hold a
    bf16 divergence to its own rule."""
    from skypilot_tpu_torch.infer import adapters as ad_lib
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    cfg = llama.CONFIGS[config]
    rank = 4 if small else 16
    if requests is None:
        requests = n_adapters if small else 2 * n_adapters
    if prompt_len is None:
        prompt_len = 16 if small else 128
    if new_tokens is None:
        new_tokens = 32 if small else 256
    slots = requests
    max_len = 256 if small else 2048
    log(f"adapter bench: {config} on {_device_kind(dev)} rank={rank} "
        f"n_adapters={n_adapters} requests={requests}")

    catalog = ad_lib.AdapterCatalog(cfg, n_adapters=n_adapters + 1,
                                    rank=rank, device=dev)
    # Registered fine-tunes: n_adapters for the mixed phase plus as many
    # again for the churn phase (they cannot all be resident).
    names = [f"ft-{i}" for i in range(2 * n_adapters)]
    for i, name in enumerate(names):
        catalog.register(name, params=adapter_tree(cfg, rank, 100 + i))

    kw = dict(n_slots=slots, max_len=max_len,
              prompt_buckets=(prompt_len,), kv_int8=kv_int8,
              prefill_chunk=0, prefix_pool=0, max_wave=slots,
              spec_k=spec_k, adapters=catalog, device=dev)
    if weights_int8:
        params, qw = kvcache.random_quantized_params(cfg, device=dev)
        e = eng.InferenceEngine(params, cfg, qweights=qw, **kw)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
        e = eng.InferenceEngine(params, cfg, **kw)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
               for _ in range(requests)]
    # Production startup: every program key (the adapter-install one
    # included) dispatched once, then the compile watch armed.
    e.warm_programs(max_burst=max_burst)
    e.declare_warmup_complete()

    def decode_pass(adapter_names):
        ids = [e.add_request(p, max_new_tokens=new_tokens, adapter=a)
               for p, a in zip(prompts, adapter_names)]
        e.admit()
        _sync(dev)
        t0 = time.time()
        while e.slot_req:
            e.decode_burst(max_burst)
        _sync(dev)
        wall = time.time() - t0
        by_rid = {r.rid: list(r.tokens) for r in e.finished}
        outs = [by_rid[i] for i in ids]
        e.finished.clear()
        dtoks = sum(len(o) for o in outs) - len(outs)
        return outs, wall / max(dtoks, 1)

    single = [names[0]] * requests
    mixed = [names[i % n_adapters] for i in range(requests)]

    # Warm both gather patterns (and the adapters) outside the window.
    decode_pass(single)
    decode_pass(mixed)

    out_single, tpot_single = decode_pass(single)
    out_mixed, tpot_mixed = decode_pass(mixed)

    # Greedy parity: the mixed batch must emit exactly what each
    # fine-tune emits alone (sequential single-request passes).
    parity_ok = True
    seq = []
    for p, a, want in zip(prompts, mixed, out_mixed):
        rid = e.add_request(p, max_new_tokens=new_tokens, adapter=a)
        e.admit()
        while e.slot_req:
            e.decode_burst(max_burst)
        got = {r.rid: list(r.tokens) for r in e.finished}[rid]
        e.finished.clear()
        seq.append((p, a, want, got))
        if got != want:
            parity_ok = False
            if tokens_out is None:
                break
    if tokens_out is not None:
        tokens_out["parity"] = seq

    # Hot-load churn: cycle through 2x the pool's fine-tunes under live
    # decode; every wave demand-loads (LRU evict + install) into the
    # same tensors.
    ptrs = [ab[k].data_ptr() for ab in catalog.pool.values() for k in ab]
    loads_before = catalog.loads
    for i in range(0, len(names), n_adapters):
        batch = [names[(i + j) % len(names)]
                 for j in range(min(n_adapters, requests))]
        for p, a in zip(prompts, batch):
            e.add_request(p, max_new_tokens=4, adapter=a)
        e.run_to_completion()
        e.finished.clear()
    churn_loads = catalog.loads - loads_before
    if [ab[k].data_ptr() for ab in catalog.pool.values()
            for k in ab] != ptrs:
        raise AssertionError("an adapter install moved the pool's tensors")

    overhead = tpot_mixed / max(tpot_single, 1e-9)
    unexpected = list(e.compile_watch.unexpected)
    log(f"adapters: single {tpot_single * 1e3:.2f}ms/tok mixed "
        f"{tpot_mixed * 1e3:.2f}ms/tok (x{overhead:.3f}) "
        f"parity={parity_ok} churn_loads={churn_loads} "
        f"evictions={catalog.evictions} unexpected={len(unexpected)}")
    del e
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "tpot_single_ms": round(tpot_single * 1e3, 3),
        "tpot_mixed_ms": round(tpot_mixed * 1e3, 3),
        # The reference's regression-gate input (<= 1.15x on a TPU).
        "overhead_ratio": round(overhead, 3),
        "parity_ok": bool(parity_ok),
        "hot_loads": int(churn_loads),
        "evictions": int(catalog.evictions),
        "unexpected_compiles": len(unexpected),
        "n_adapters": n_adapters,
        "rank": rank,
        "requests": requests,
        "new_tokens": new_tokens,
        "spec_k": spec_k,
        "backend": dev.type,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
    }


def run_adapters_smoke(device: DeviceLike = None) -> dict:
    """CI-sized adapter-catalog pass: parity and churn are asserted by
    tests/test_torch_bench_serve.py; wall-clock is reported."""
    return run_adapters(smoke=True, n_adapters=4, device=device)


def run_qos_smoke(device: DeviceLike = None) -> dict:
    """CI-sized QoS pass: scheduling and preemption parity and the
    fairness structure are asserted by tests/test_torch_bench_serve.py;
    wall-clock ratios are reported."""
    return run_qos(smoke=True, device=device)


def run_smoke(device: DeviceLike = None) -> dict:
    """CI-sized prefix-share + interference pass (the regression guard
    for the chunk scheduler; see tests/test_torch_bench_serve.py)."""
    return run_prefix_share(smoke=True, device=device)


class _OracleDrafter:
    """Replays a known-correct continuation as the draft: the acceptance
    ceiling of the verify path, where every round accepts the full
    draft, whatever the random-weight model's output looks like."""

    def __init__(self, out):
        self.out = list(out)
        self._gen = 0

    def catch_up(self, prompt, generated):
        self._gen = len(generated)

    def draft(self, k):
        return self.out[self._gen:self._gen + k]


def run_spec(config=None, spec_k=4, requests=None, prompt_len=16,
             new_tokens=None, max_burst=8, kv_int8=False,
             weights_int8=False, smoke=False, draft_layers=None,
             device: DeviceLike = None, tokens_out=None) -> dict:
    """Speculative-decoding bench, two workloads on two engines.

    **Phase A, non-repetitive (the headline).** Random prompts at the
    config's full vocabulary: the random-weight target's greedy output
    does not cycle, so prompt lookup has nothing to find and any gain
    must come from the model drafter. The draft model is the
    truncated-layer draft of a self-distilled target
    (``draft.self_distilled_pair``: the target's blocks past
    ``draft_layers``, half its depth by default, carry zeroed output
    projections), so acceptance is near 1.0 without a training run and
    the zeroed layers still pay their matmuls. Passes on one engine
    (only the routing flips): spec-off, model draft pipelined, model
    draft synchronous (the pipeline's share), n-gram, and the pipeline's
    structure: each pipelined round's predraft dispatched inside its
    verify's dispatch-to-fetch window (``overlap_ok``).

    **Phase B, repetition-heavy.** The reference's earlier workload:
    vocabulary 16, so the random model's output cycles and prompt lookup
    pays; n-gram and oracle-draft passes.

    TTFT is out of scope: speculation replaces only decode bursts.
    ``smoke=True`` (or the CPU) runs the reference's CI sizes; wall-clock
    is reported, never gated. The reference's names, defaults and report
    keys, but for three deliberate differences: the port has no flight
    ``backend`` is the torch device type; and the port compiles
    nothing, so each warm-up pass runs two verify rounds' worth of
    tokens (enough to launch every program of the pass once), not the
    whole budget. ``tokens_out``, a dict,
    receives the token lists behind the parity verdicts: ``"a"``
    (prompts; spec-off, model pipelined, model synchronous and n-gram
    outputs) and ``"b"`` (prompts; spec-off, n-gram and oracle outputs),
    so that a caller can hold a divergence to its own rule: the port's
    kernel path computes a round's staged columns as bf16 products and
    its cached ones in float32, as the reference's kernel path does, so
    a verify round may flip a greedy token at a near-tie."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    if requests is None:
        requests = 4 if small else 8
    if new_tokens is None:
        new_tokens = 96 if small else 256
    spec_k = max(int(spec_k), 1)
    slots = requests
    max_len = 128 if small else 512
    assert prompt_len + new_tokens + spec_k + 1 <= max_len
    # Separate streams: phase B keeps the reference's earlier prompts.
    rng_a = np.random.default_rng(1)
    rng_b = np.random.default_rng(0)

    warmup_tokens = 2 * (spec_k + 1)

    def decode_pass(e, prompts, spec_on, factory=None,
                    ngram_factory=None, draft_engine=None,
                    pipeline=False, budget=None):
        """One admit-then-decode pass of ``budget`` new tokens (default
        ``new_tokens``); TPOT over the decode loop only. Returns
        (outputs, tpot_s, drafted, accepted, bursts)."""
        e.spec_k = spec_k if spec_on else 0
        e._spec_drafter_factory = factory or ngram_factory
        e.draft_engine = draft_engine
        e.spec_pipeline = bool(pipeline) and draft_engine is not None
        d0, a0 = e._spec_drafted_total, e._spec_accepted_total
        ids = [e.add_request(p, max_new_tokens=budget or new_tokens)
               for p in prompts]
        e.admit()
        _sync(dev)
        t0 = time.time()
        bursts = 0
        while e.slot_req:
            e.decode_burst(max_burst)
            bursts += 1
        _sync(dev)
        wall = time.time() - t0
        by_rid = {r.rid: list(r.tokens) for r in e.finished}
        outs = [by_rid[i] for i in ids]
        e.finished.clear()
        dtoks = sum(len(o) for o in outs) - len(outs)
        return (outs, wall / max(dtoks, 1),
                e._spec_drafted_total - d0,
                e._spec_accepted_total - a0, bursts)

    def params_for(cfg):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)

    # -- Phase A: non-repetitive workload, model drafter ------------------
    cfg_a = llama.CONFIGS[config]
    if draft_layers is None:
        draft_layers = max(cfg_a.n_layers // 2, 1)
    params_a = params_for(cfg_a)
    target, dparams, dcfg = draft_lib.self_distilled_pair(
        params_a, cfg_a, draft_layers)
    del params_a
    qw_t = qw_d = None
    if weights_int8:
        # The draft's int8 tree is the layer slice of the target's: the
        # zeroed upper blocks quantize to exact zeros, so the agreement
        # survives quantization.
        qw_t = {"blocks": kvcache.quantize_block_weights(target),
                "head": kvcache.quantize_head(target, cfg_a)}
        qw_d = {"blocks": {
                    name: {k: v[:draft_layers]
                           for k, v in qw_t["blocks"][name].items()}
                    for name in qw_t["blocks"]},
                "head": qw_t["head"]}
        dparams = kvcache.slim_params(dparams)
        target = kvcache.slim_params(target)
    log(f"spec bench A: {config} (vocab {cfg_a.vocab_size}, "
        f"non-repetitive) K={spec_k} draft={draft_layers}/"
        f"{cfg_a.n_layers} layers requests={requests} "
        f"new_tokens={new_tokens} w8a8={bool(weights_int8)} on "
        f"{_device_kind(dev)}")
    e_a = eng.InferenceEngine(
        target, cfg_a, n_slots=slots, max_len=max_len,
        prompt_buckets=(prompt_len,), kv_int8=kv_int8, qweights=qw_t,
        prefill_chunk=0, prefix_pool=0, max_wave=slots, spec_k=spec_k,
        device=dev, flight_recorder=flight_lib.FlightRecorder())
    fl = e_a.flight
    ngram_factory_a = e_a._spec_drafter_factory
    de = draft_lib.DraftEngine(dparams, dcfg, n_slots=slots,
                               max_len=max_len, kv_int8=kv_int8,
                               qweights=qw_d, device=dev)
    prompts_a = [rng_a.integers(1, cfg_a.vocab_size,
                                prompt_len).tolist()
                 for _ in range(requests)]

    def pass_a(spec_on, draft_engine=None, pipeline=False, budget=None):
        return decode_pass(e_a, prompts_a, spec_on,
                           ngram_factory=ngram_factory_a,
                           draft_engine=draft_engine, pipeline=pipeline,
                           budget=budget)

    # Warmups, as the reference's: the off pass, the pipelined and the
    # synchronous model passes (allocator and first launches here).
    pass_a(False, budget=warmup_tokens)
    pass_a(True, draft_engine=de, pipeline=True, budget=warmup_tokens)
    de.reset()
    pass_a(True, draft_engine=de, pipeline=False, budget=warmup_tokens)
    de.reset()

    out_off_a, tpot_off_a, _, _, bursts_off_a = pass_a(False)
    seq0 = fl.seq()
    out_m, tpot_m, dr_m, ac_m, bursts_m = pass_a(
        True, draft_engine=de, pipeline=True)
    recs = fl.since(seq0)
    reuse_hits, rollouts = de.reuse_hits, de.rollouts
    de.reset()
    out_ms, tpot_ms, dr_ms, ac_ms, bursts_ms = pass_a(
        True, draft_engine=de, pipeline=False)
    de.reset()
    out_ng, tpot_ng, dr_ng, ac_ng, bursts_ng = pass_a(True)

    # Structural overlap evidence: a "draft" record whose dispatch
    # landed inside a verify record's dispatch-to-fetch window, the
    # pipeline's whole point, timing-free.
    verify_recs = [r for r in recs if r.get("burst") == "verify"]
    draft_recs = [r for r in recs if r.get("burst") == "draft"]
    overlapped = 0
    for d in draft_recs:
        for v in verify_recs:
            if (v["ts_s"] <= d["ts_s"]
                    <= v["ts_s"] + float(v.get("dur_s", 0.0))):
                overlapped += 1
                break
    overlap_ok = bool(draft_recs) and overlapped == len(draft_recs)

    model_parity = out_m == out_off_a
    sync_parity = out_ms == out_off_a
    ngram_parity = out_ng == out_off_a
    rate_m = ac_m / max(dr_m, 1)
    rate_ng = ac_ng / max(dr_ng, 1)
    log(f"spec A: off {tpot_off_a * 1e3:.2f}ms/tok "
        f"model(pipe) {tpot_m * 1e3:.2f}ms (accept {rate_m:.2f}, "
        f"{overlapped}/{len(draft_recs)} draft dispatches "
        f"overlapped, {reuse_hits} rounds predraft-served) "
        f"model(sync) {tpot_ms * 1e3:.2f}ms "
        f"ngram {tpot_ng * 1e3:.2f}ms (accept {rate_ng:.2f}) "
        f"parity={model_parity}/{sync_parity}/{ngram_parity}")
    if tokens_out is not None:
        tokens_out["a"] = (prompts_a, out_off_a, out_m, out_ms, out_ng)
    del e_a, de, target, dparams, qw_t, qw_d
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- Phase B: repetition-heavy workload, n-gram + oracle --------------
    # Vocabulary 16: the random model's greedy decode cycles quickly;
    # the block weights, the decode cost, keep the config's size.
    cfg_b = dataclasses.replace(llama.CONFIGS[config], vocab_size=16)
    log(f"spec bench B: {config} (vocab 16, repetition-heavy) "
        f"K={spec_k}")
    kw = dict(n_slots=slots, max_len=max_len,
              prompt_buckets=(prompt_len,), kv_int8=kv_int8,
              prefill_chunk=0, prefix_pool=0, max_wave=slots,
              spec_k=spec_k, device=dev)
    if weights_int8:
        params_b, qw = kvcache.random_quantized_params(cfg_b, device=dev)
        e_b = eng.InferenceEngine(params_b, cfg_b, qweights=qw, **kw)
    else:
        e_b = eng.InferenceEngine(params_for(cfg_b), cfg_b, **kw)
    ngram_factory_b = e_b._spec_drafter_factory
    prompts_b = [rng_b.integers(1, cfg_b.vocab_size,
                                prompt_len).tolist()
                 for _ in range(requests)]

    def pass_b(spec_on, factory=None, budget=None):
        return decode_pass(e_b, prompts_b, spec_on, factory=factory,
                           ngram_factory=ngram_factory_b, budget=budget)

    pass_b(False, budget=warmup_tokens)
    pass_b(True, budget=warmup_tokens)

    out_off, tpot_off, _, _, bursts_off = pass_b(False)
    out_on, tpot_on, drafted, accepted, bursts_on = pass_b(True)
    oracle = {tuple(p): o for p, o in zip(prompts_b, out_off)}
    out_or, tpot_or, dr_or, ac_or, bursts_or = pass_b(
        True,
        factory=lambda req: _OracleDrafter(oracle[tuple(req.prompt)]))

    if tokens_out is not None:
        tokens_out["b"] = (prompts_b, out_off, out_on, out_or)
    parity_ok = out_on == out_off
    oracle_parity_ok = out_or == out_off
    rate = accepted / max(drafted, 1)
    oracle_rate = ac_or / max(dr_or, 1)
    dtoks = sum(len(o) for o in out_off) - len(out_off)
    log(f"spec B: off {tpot_off * 1e3:.2f}ms/tok ({bursts_off} bursts) "
        f"ngram {tpot_on * 1e3:.2f}ms ({bursts_on} bursts, "
        f"accept {rate:.2f}) oracle {tpot_or * 1e3:.2f}ms "
        f"({bursts_or} bursts, accept {oracle_rate:.2f}) "
        f"parity={parity_ok}/{oracle_parity_ok}")
    return {
        # -- Phase A (non-repetitive, model drafter): the headline.
        "backend": dev.type,
        "model_tpot_off_ms": round(tpot_off_a * 1e3, 3),
        "tpot_model_ms": round(tpot_m * 1e3, 3),
        "tpot_model_sync_ms": round(tpot_ms * 1e3, 3),
        "tpot_ngram_nonrep_ms": round(tpot_ng * 1e3, 3),
        "model_speedup": round(tpot_off_a / max(tpot_m, 1e-9), 3),
        "model_sync_speedup": round(tpot_off_a / max(tpot_ms, 1e-9),
                                    3),
        "pipeline_ratio": round(tpot_ms / max(tpot_m, 1e-9), 3),
        "ngram_nonrep_speedup": round(tpot_off_a / max(tpot_ng, 1e-9),
                                      3),
        "model_accept_rate": round(rate_m, 3),
        "model_sync_accept_rate": round(ac_ms / max(dr_ms, 1), 3),
        "ngram_nonrep_accept_rate": round(rate_ng, 3),
        "model_parity_ok": bool(model_parity),
        "model_sync_parity_ok": bool(sync_parity),
        "ngram_nonrep_parity_ok": bool(ngram_parity),
        "overlap_ok": bool(overlap_ok),
        "draft_records": len(draft_recs),
        "draft_reuse_hits": int(reuse_hits),
        "draft_rollouts": int(rollouts),
        "draft_layers": int(draft_layers),
        "bursts_model": int(bursts_m),
        "bursts_model_sync": int(bursts_ms),
        # -- Phase B (repetition-heavy, n-gram + oracle).
        "tpot_off_ms": round(tpot_off * 1e3, 3),
        "tpot_spec_ms": round(tpot_on * 1e3, 3),
        "tpot_oracle_ms": round(tpot_or * 1e3, 3),
        "speedup": round(tpot_off / max(tpot_on, 1e-9), 3),
        "oracle_speedup": round(tpot_off / max(tpot_or, 1e-9), 3),
        "accept_rate": round(rate, 3),
        "oracle_accept_rate": round(oracle_rate, 3),
        "drafted": int(drafted),
        "accepted": int(accepted),
        "parity_ok": bool(parity_ok),
        "oracle_parity_ok": bool(oracle_parity_ok),
        "bursts_off": int(bursts_off),
        "bursts_spec": int(bursts_on),
        "bursts_oracle": int(bursts_or),
        "decode_tokens": int(dtoks),
        "spec_k": spec_k,
        "requests": requests,
        "new_tokens": new_tokens,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
    }


def run_spec_smoke(device: DeviceLike = None) -> dict:
    """CI-sized spec pass: parity on every column, oracle acceptance
    1.0, the model drafter's acceptance and the pipeline's structure are
    asserted by tests/test_torch_bench_serve.py; wall-clock is
    reported, never gated."""
    return run_spec(smoke=True, device=device)


def _random_weights(cfg, weights_int8: bool, dev: torch.device):
    """(params, qweights) from seed 0 on ``dev``: int8 weights drawn
    directly (``kvcache.random_quantized_params``) with
    ``weights_int8``, else the float tree in ``cfg.dtype`` and None."""
    if weights_int8:
        return kvcache.random_quantized_params(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype), None


def _kv_bytes(e) -> int:
    """Bytes of an engine's KV tensors (values and scales), trash rows
    included."""
    return sum(e.cache[n].numel() * e.cache[n].element_size()
               for n in ("k", "v", "k_scale", "v_scale") if n in e.cache)


def run_occupancy(config=None, smoke=False, kv_int8=False,
                  weights_int8=False, factor=8, max_burst=4,
                  device: DeviceLike = None, tokens_out=None) -> dict:
    """High-occupancy decode sweep (the reference's ``run_occupancy``):
    concurrent decode slots at the SAME KV bytes, the paged cache
    against the contiguous layout.

    Requests need max_len/8 rows each (prompt plus budget) on engines
    sized for max_len. The contiguous engine holds ``slots_c`` rows of
    max_len; the paged engine gets ``factor`` times the slots and a
    pool of the same bytes, so admission itself shows that the blocks
    suffice, and the greedy outputs are compared token for token.
    ``blocks_per_token``: allocated block rows per resident token at
    peak (eager allocation).

    Equal bytes count every row each cache allocates, trash rows
    included: the contiguous cache's ``slots_c + 1`` max_len rows (the
    last its trash slot, the reference's spare slot) against the paged
    pool's ``(slots_c + 1) * max_len / block`` blocks (the last its
    trash block), so ``kv_blocks`` is one less than that. The paged
    engine's reads run K1, the contiguous one's the gather: its parity
    spans both layouts and both read paths, as the reference's
    ``kv_kernel`` variant does. Sizes (the reference's): ``smoke`` or
    the CPU: llama3-tiny, max_len 64, blocks of 8, 4-token prompts, 2
    contiguous slots; else llama3-400m, max_len 4096, blocks of 256,
    256-token prompts, 8 contiguous slots. ``tokens_out``, a dict,
    receives ``"parity"``: (prompts, paged outputs, contiguous
    outputs)."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    cfg = llama.CONFIGS[config]
    max_len = 64 if small else 4096
    kv_block = 8 if small else 256
    plen = 4 if small else 256
    new_tokens = max_len // 8 - plen
    slots_c = 2 if small else 8
    requests = slots_c * factor
    log(f"occupancy bench: {config} max_len={max_len} block={kv_block} "
        f"need={plen + new_tokens} rows/req on {_device_kind(dev)}")
    params, qw = _random_weights(cfg, weights_int8, dev)
    kw = dict(max_len=max_len, prompt_buckets=(plen,), kv_int8=kv_int8,
              qweights=qw, prefill_chunk=0, prefix_pool=0, max_wave=8,
              device=dev)
    nb = max_len // eng.paged_block_len(max_len, kv_block, dev, kv_int8)
    e_paged = eng.InferenceEngine(params, cfg, n_slots=slots_c * factor,
                                  kv_block=kv_block,
                                  kv_blocks=(slots_c + 1) * nb - 1, **kw)
    e_contig = eng.InferenceEngine(params, cfg, n_slots=slots_c,
                                   kv_block=0, **kw)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, plen).tolist()
               for _ in range(requests)]

    def drive(e):
        ids = [e.add_request(p, max_new_tokens=new_tokens)
               for p in prompts]
        peak, bpt = 0, None
        while e.waiting or e.chunking or e.slot_req:
            # Occupancy is sampled right after admission, before a burst
            # can retire short requests: the peak is what the cache held.
            e.admit()
            while e.chunking:
                e.prefill_chunk_step()
            occ = len(e.slot_req)
            if occ >= peak:
                peak = occ
                if e.paged:
                    toks = sum(len(r.prompt) + len(r.tokens)
                               for r in e.slot_req.values())
                    bpt = e.blocks_used() * e.kv_block / max(toks, 1)
            e.decode_burst(max_burst=max_burst)
        by_rid = {r.rid: r.tokens for r in e.finished}
        e.finished.clear()
        return [by_rid[i] for i in ids], peak, bpt

    out_c, peak_c, _ = drive(e_contig)
    out_p, peak_p, bpt = drive(e_paged)
    parity_ok = out_p == out_c
    leak_free = e_paged.blocks_used() == 0
    bytes_p, bytes_c = _kv_bytes(e_paged), _kv_bytes(e_contig)
    occupancy_x = peak_p / max(peak_c, 1)
    if tokens_out is not None:
        tokens_out["parity"] = (prompts, out_p, out_c)
    log(f"occupancy: contiguous {peak_c} slots vs paged {peak_p} at "
        f"{bytes_p / 1e6:.1f} MB KV ({occupancy_x:.1f}x, "
        f"parity={parity_ok})")
    del e_paged, e_contig
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "kv_hbm_bytes": bytes_p,
        "kv_hbm_bytes_contiguous": bytes_c,
        "same_hbm": bool(bytes_p == bytes_c),
        "paged_slots": peak_p,
        "contiguous_slots": peak_c,
        "occupancy_x": round(occupancy_x, 2),
        "blocks_per_token": round(bpt, 3) if bpt else None,
        "kv_block": kv_block,
        "parity_ok": bool(parity_ok),
        "leak_free": bool(leak_free),
        # The reference's bar: >= 4x concurrent slots at equal KV bytes.
        "occupancy_regressed": bool(occupancy_x < 4 or not parity_ok
                                    or bytes_p != bytes_c),
        "requests": requests,
        "max_len": max_len,
        "new_tokens": new_tokens,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
        # The paged engine reads through K1's wrapper (its plain version
        # on CPU tensors); there is no gather to choose on a paged cache.
        "kv_kernel": True,
        "backend": dev.type,
    }


def run_span(config=None, requests=None, prompt_len=None,
             new_tokens=None, max_burst=8, kv_int8=False,
             weights_int8=False, spec_k=0, smoke=False,
             device: DeviceLike = None, tokens_out=None) -> dict:
    """Span-bucketed decode attention bench (the reference's
    ``run_span``): span-on against full-view decode TPOT on the SAME
    paged engine (the ladder is host-side dispatch state: toggling it
    only routes bursts to other span arguments), greedy parity asserted.

    Workload: short active conversations on a long-max_len engine, every
    request within max_len/8 rows; the full view reads max_len rows per
    slot per layer per step, the span path the active rung. TTFT is out
    of scope (admission waves take no span). ``spec_k``: the comparison
    through the verify path. Sizes (the reference's): ``smoke`` or the
    CPU: max_len 2048, blocks of 64, 16-token prompts, 96 new tokens;
    else max_len 4096, blocks of 256, 128-token prompts, 256 new; 8
    requests. The big-cache reads run K1 on the card. ``tokens_out``, a
    dict, receives ``"parity"``: (prompts, span outputs, full-view
    outputs). Wall ratios are reported, never gated."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    cfg = llama.CONFIGS[config]
    max_len = 2048 if small else 4096
    kv_block = 64 if small else 256
    if requests is None:
        requests = 8
    if prompt_len is None:
        prompt_len = 16 if small else 128
    if new_tokens is None:
        new_tokens = 96 if small else 256
    slots = requests
    need = prompt_len + new_tokens + (spec_k + 1 if spec_k else 0)
    assert need <= max_len // 8, "workload must fit the smallest rungs"
    log(f"span bench: {config} max_len={max_len} block={kv_block} "
        f"active<={need} rows/req requests={requests} on "
        f"{_device_kind(dev)}")
    params, qw = _random_weights(cfg, weights_int8, dev)
    e = eng.InferenceEngine(
        params, cfg, qweights=qw, n_slots=slots, max_len=max_len,
        prompt_buckets=(prompt_len,), kv_int8=kv_int8, prefill_chunk=0,
        prefix_pool=0, max_wave=slots, kv_block=kv_block, spec_k=spec_k,
        device=dev)
    del params
    ladder = e.span_ladder
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
               for _ in range(requests)]

    def decode_pass(span_on):
        """One admit-then-decode pass; TPOT over the decode loop only.
        Returns (outputs, tpot_s, the largest span dispatched)."""
        e.span_ladder = ladder if span_on else (e.max_len,)
        e.decode_programs.clear()
        ids = [e.add_request(p, max_new_tokens=new_tokens)
               for p in prompts]
        e.admit()
        _sync(dev)
        t0 = time.time()
        while e.slot_req:
            e.decode_burst(max_burst)
        _sync(dev)
        wall = time.time() - t0
        by_rid = {r.rid: list(r.tokens) for r in e.finished}
        outs = [by_rid[i] for i in ids]
        e.finished.clear()
        rows = max((sp if sp is not None else e.max_len)
                   for _, _, sp in e.decode_programs)
        dtoks = sum(len(o) for o in outs) - len(outs)
        return outs, wall / max(dtoks, 1), rows

    # Warm-up: both modes' first launches outside the timed window.
    decode_pass(False)
    decode_pass(True)
    out_full, tpot_full, rows_full = decode_pass(False)
    out_span, tpot_span, rows_span = decode_pass(True)
    e.span_ladder = ladder
    parity_ok = out_span == out_full
    n_programs = len(e.decode_programs)
    if tokens_out is not None:
        tokens_out["parity"] = (prompts, out_span, out_full)
    log(f"span: full {tpot_full * 1e3:.2f}ms/tok ({rows_full} rows) "
        f"span {tpot_span * 1e3:.2f}ms ({rows_span} rows, "
        f"{n_programs} programs) parity={parity_ok}")
    del e
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "tpot_full_ms": round(tpot_full * 1e3, 3),
        "tpot_span_ms": round(tpot_span * 1e3, 3),
        "speedup": round(tpot_full / max(tpot_span, 1e-9), 3),
        "rows_full": int(rows_full),
        "rows_span": int(rows_span),
        "rows_ratio": round(rows_full / max(rows_span, 1), 2),
        "span_ladder": list(ladder),
        "n_span_programs": int(n_programs),
        "parity_ok": bool(parity_ok),
        "max_len": max_len,
        "kv_block": kv_block,
        "requests": requests,
        "new_tokens": new_tokens,
        "spec_k": spec_k,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
        # The paged engine reads through K1's wrapper (its plain version
        # on CPU tensors); there is no gather to choose on a paged cache.
        "kv_kernel": True,
        "backend": dev.type,
    }


def run_span_smoke(device: DeviceLike = None, tokens_out=None) -> dict:
    """CI-sized span pass: parity and the rows/program structure are
    asserted (``tests/test_torch_bench_serve.py``); wall ratios are
    reported, never gated."""
    return run_span(smoke=True, device=device, tokens_out=tokens_out)


def run_kernel(config=None, requests=None, prompt_len=None,
               new_tokens=None, max_burst=8, kv_int8=False,
               weights_int8=False, spec_k=0, smoke=False,
               device: DeviceLike = None, tokens_out=None) -> dict:
    """Paged decode-attention kernel bench (the reference's
    ``run_kernel``): K1 against the plain read, decode TPOT on the SAME
    engine, greedy parity asserted.

    The kernel-off leg is the engine's plain route for its big-cache
    reads (``paged_attention_ref``, the plain version K1 is held to),
    flipped per pass on one engine as the reference flips its static
    ``kernel`` flag; admission waves are the same in both (they never
    read the cache). This is the bench's own A/B and lies on no serving
    path. Workload: low occupancy, a few active requests on an engine
    sized for many slots. The program keys carry ``kernel=True`` and
    ``kernel=False`` (``kernel_programs_ok``). On the CPU both legs run
    the plain version, so its times say nothing. Sizes (the
    reference's): ``smoke`` or the CPU: max_len 256, blocks of 32, 8
    slots, 2 requests of 8 prompt and 16 new tokens; else max_len 4096,
    blocks of 256, 16 slots, 4 requests of 128 and 256. Full size on the
    card re-runs :func:`run_span` and :func:`run_occupancy`, as the
    reference does. ``tokens_out``, a dict, receives ``"parity"``:
    (prompts, kernel outputs, plain outputs)."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    cfg = llama.CONFIGS[config]
    max_len = 256 if small else 4096
    kv_block = 32 if small else 256
    slots = 8 if small else 16
    if requests is None:
        requests = 2 if small else 4
    if prompt_len is None:
        prompt_len = 8 if small else 128
    if new_tokens is None:
        new_tokens = 16 if small else 256
    log(f"kernel bench: {config} max_len={max_len} block={kv_block} "
        f"slots={slots} active={requests} (low occupancy) on "
        f"{_device_kind(dev)}")
    params, qw = _random_weights(cfg, weights_int8, dev)
    e = eng.InferenceEngine(
        params, cfg, qweights=qw, n_slots=slots, max_len=max_len,
        prompt_buckets=(prompt_len,), kv_int8=kv_int8, prefill_chunk=0,
        prefix_pool=0, max_wave=slots, kv_block=kv_block, spec_k=spec_k,
        device=dev)
    del params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
               for _ in range(requests)]

    def decode_pass(kernel_on):
        """One admit-then-decode pass; TPOT over the decode loop only."""
        e._kernel = kernel_on
        ids = [e.add_request(p, max_new_tokens=new_tokens)
               for p in prompts]
        e.admit()
        _sync(dev)
        t0 = time.time()
        while e.slot_req:
            e.decode_burst(max_burst)
        _sync(dev)
        wall = time.time() - t0
        by_rid = {r.rid: list(r.tokens) for r in e.finished}
        outs = [by_rid[i] for i in ids]
        e.finished.clear()
        dtoks = sum(len(o) for o in outs) - len(outs)
        return outs, wall / max(dtoks, 1)

    decode_pass(False)
    decode_pass(True)
    out_plain, tpot_plain = decode_pass(False)
    out_kernel, tpot_kernel = decode_pass(True)
    e._kernel = True
    parity_ok = out_kernel == out_plain
    keys = e.compile_watch.summary()
    kernel_programs_ok = (any("kernel=True" in k for k in keys)
                          and any("kernel=False" in k for k in keys))
    speedup = tpot_plain / max(tpot_kernel, 1e-9)
    if tokens_out is not None:
        tokens_out["parity"] = (prompts, out_kernel, out_plain)
    log(f"kernel: plain {tpot_plain * 1e3:.2f}ms/tok kernel "
        f"{tpot_kernel * 1e3:.2f}ms/tok ({speedup:.2f}x, "
        f"parity={parity_ok}, backend={dev.type})")
    ladder = list(e.span_ladder)
    del e
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {
        "tpot_gather_ms": round(tpot_plain * 1e3, 3),
        "tpot_kernel_ms": round(tpot_kernel * 1e3, 3),
        "speedup": round(speedup, 3),
        "parity_ok": bool(parity_ok),
        "kernel_programs_ok": bool(kernel_programs_ok),
        "backend": dev.type,
        "active_requests": requests,
        "slots": slots,
        "max_len": max_len,
        "kv_block": kv_block,
        "span_ladder": ladder,
        "new_tokens": new_tokens,
        "spec_k": spec_k,
        "config": config,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
    }
    if not small:
        sa = run_span(config=config, kv_int8=kv_int8,
                      weights_int8=weights_int8, device=dev)
        out["span_under_kernel_speedup"] = sa["speedup"]
        out["span_under_kernel_parity_ok"] = sa["parity_ok"]
        oc = run_occupancy(config=config, kv_int8=kv_int8,
                           weights_int8=weights_int8, device=dev)
        out["occupancy_under_kernel_x"] = oc["occupancy_x"]
        out["occupancy_under_kernel_ok"] = not oc["occupancy_regressed"]
    return out


def run_kernel_smoke(device: DeviceLike = None, tokens_out=None) -> dict:
    """CI-sized kernel pass: parity and program identity are asserted
    (``tests/test_torch_bench_serve.py``); wall ratios are reported,
    never gated."""
    return run_kernel(smoke=True, device=device, tokens_out=tokens_out)


def run_flight(config=None, requests=None, new_tokens=None,
               max_burst=8, spec_k=4, kv_int8=False,
               weights_int8=False, smoke=False,
               device: DeviceLike = None) -> dict:
    """Flight recorder + compile watch bench over the full mixed
    workload (the reference's ``run_flight``): chunked admission with
    prefix reuse, n-gram speculation and span regrouping, on a paged
    engine AND a contiguous twin. Per layout:

      1. ``warm_programs()`` dispatches every program key once, one
         untimed workload pass covers anything workload-specific, then
         the engine declares warmup complete (the ``--warm-grid``
         startup).
      2. The timed window runs the same workload and checks the
         introspection contract: ``unexpected_compiles == 0`` and the
         decode/verify programs the engine selected
         (``decode_programs``) equal the records' program identities,
         both directions.
      3. Recorder-on against recorder-off passes (``overhead_ratio``),
         calibration off (``SKYTPU_DEVTIME_EVERY=0``) and forensics
         off: greedy outputs must be identical each time (recording only
         observes).

    ``layouts`` holds ``"paged"`` and ``"contig"``; the aggregate takes
    the worst layout. The reference's names, sizes (``smoke`` or the
    CPU: llama3-tiny, 6 requests of 24 new tokens, max_len 256, chunks
    of 24, blocks of 32; else llama3-400m, 16 requests of 128, max_len
    2048, chunks of 256, blocks of 128) and report keys. Vocabulary 16,
    so the random model's greedy output cycles and the n-gram drafter
    drafts. Wall ratios are reported, never gated."""
    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    if config is None:
        config = "llama3-tiny" if on_cpu else "llama3-400m"
    small = smoke or on_cpu
    if requests is None:
        requests = 6 if small else 16
    if new_tokens is None:
        new_tokens = 24 if small else 128
    max_len = 256 if small else 2048
    chunk = 24 if small else 256
    kv_block = 32 if small else 128   # not dividing chunk-aligned
    #                                   prefixes cleanly: COW runs
    short_len, long_a, long_b = (12, 60, 72) if small \
        else (96, 640, 768)
    shared = 2 * chunk                # chunk-aligned shared prefix
    slots = requests
    cfg = dataclasses.replace(llama.CONFIGS[config], vocab_size=16)
    rng = np.random.default_rng(0)
    base = rng.integers(1, cfg.vocab_size, shared).tolist()
    prompts = (
        [rng.integers(1, cfg.vocab_size, short_len).tolist()
         for _ in range(requests - 4)]
        + [base + rng.integers(1, cfg.vocab_size,
                               long_a - shared).tolist(),
           base + rng.integers(1, cfg.vocab_size,
                               long_b - shared).tolist()] * 2)
    log(f"flight bench: {config} (vocab 16) max_len={max_len} "
        f"chunk={chunk} block={kv_block} K={spec_k} "
        f"requests={len(prompts)} on {_device_kind(dev)}")

    def build(paged):
        params, qw = _random_weights(cfg, weights_int8, dev)
        return eng.InferenceEngine(
            params, cfg, qweights=qw, n_slots=slots, max_len=max_len,
            prompt_buckets=(16 if small else 128, max_len),
            kv_int8=kv_int8, prefill_chunk=chunk, prefix_pool=4,
            max_wave=slots, spec_k=spec_k,
            kv_block=kv_block if paged else 0, device=dev,
            flight_recorder=flight_lib.FlightRecorder())

    def workload(e):
        ids = [e.add_request(p, max_new_tokens=new_tokens)
               for p in prompts]
        _sync(dev)
        t0 = time.time()
        e.run_to_completion(max_burst)
        _sync(dev)
        wall = time.time() - t0
        by_rid = {r.rid: list(r.tokens) for r in e.finished}
        outs = [by_rid[i] for i in ids]
        e.finished.clear()
        toks = sum(len(o) for o in outs)
        return outs, wall / max(toks, 1)

    layouts = {}
    for paged in (True, False):
        e = build(paged)
        rec = e.flight
        # Production startup: the grid sweep and one untimed workload
        # pass, then the watch armed.
        warmed = e.warm_programs(max_burst=max_burst)
        workload(e)
        warm_compile_s = e.compile_watch.total_compile_s()
        e.declare_warmup_complete()
        # Timed window.
        e.decode_programs.clear()
        seq0 = rec.seq()
        out_on, tpot_on = workload(e)
        window = rec.since(seq0)
        unexpected = list(e.compile_watch.unexpected)
        rec_dv = {(r["program"]["k"], r["program"]["span"])
                  for r in window if r["burst"] in ("decode", "verify")}
        eng_dv = {(k, sp) for kind, k, sp in e.decode_programs
                  if kind in ("burst", "verify")}
        n_chunks = sum(1 for r in window if r["burst"] == "chunk")
        n_waves = sum(1 for r in window if r["burst"] == "wave")
        coverage_ok = rec_dv == eng_dv and n_chunks > 0 and n_waves > 0
        # Recorder-off guard: identical greedy output, best-of-two TPOT.
        rec.enabled = False
        out_off, tpot_off = workload(e)
        rec.enabled = True
        _, tpot_on2 = workload(e)
        rec.enabled = False
        _, tpot_off2 = workload(e)
        rec.enabled = True
        tpot_on = min(tpot_on, tpot_on2)
        tpot_off = min(tpot_off, tpot_off2)
        # Calibration off must give the same tokens: the bracket
        # observes.
        cal_samples = e.devtime.samples
        prev_every = os.environ.get("SKYTPU_DEVTIME_EVERY")
        os.environ["SKYTPU_DEVTIME_EVERY"] = "0"
        try:
            out_nocal, _ = workload(e)
        finally:
            if prev_every is None:
                os.environ.pop("SKYTPU_DEVTIME_EVERY", None)
            else:
                os.environ["SKYTPU_DEVTIME_EVERY"] = prev_every
        # Forensics off: the same tokens, best-of-two TPOT.
        e.forensics = False
        out_foff, tpot_foff = workload(e)
        e.forensics = True
        _, tpot_fon = workload(e)
        e.forensics = False
        _, tpot_foff2 = workload(e)
        e.forensics = True
        tpot_fon = min(tpot_on, tpot_fon)
        tpot_foff = min(tpot_foff, tpot_foff2)
        name = "paged" if paged else "contig"
        layouts[name] = {
            "programs_warmed": warmed,
            "warmup_compile_s": round(warm_compile_s, 3),
            "unexpected_compiles": len(unexpected),
            "unexpected": unexpected,
            "coverage_ok": bool(coverage_ok),
            "parity_ok": bool(out_on == out_off),
            "calibration_parity_ok": bool(out_nocal == out_on),
            "calibration_samples": int(cal_samples),
            "n_records": len(window),
            "n_chunk_records": n_chunks,
            "n_wave_records": n_waves,
            "tpot_on_ms": round(tpot_on * 1e3, 3),
            "tpot_off_ms": round(tpot_off * 1e3, 3),
            "overhead_ratio": round(tpot_on / max(tpot_off, 1e-9), 4),
            "forensics_parity_ok": bool(out_foff == out_on),
            "tpot_forensics_on_ms": round(tpot_fon * 1e3, 3),
            "tpot_forensics_off_ms": round(tpot_foff * 1e3, 3),
            "forensics_overhead_ratio": round(
                tpot_fon / max(tpot_foff, 1e-9), 4),
        }
        log(f"flight {name}: {layouts[name]}")
        del e
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    vals = list(layouts.values())
    return {
        "warmup_compile_s": round(
            sum(v["warmup_compile_s"] for v in vals), 3),
        "unexpected_compiles": sum(v["unexpected_compiles"] for v in vals),
        "coverage_ok": all(v["coverage_ok"] for v in vals),
        "parity_ok": all(v["parity_ok"] for v in vals),
        "calibration_parity_ok": all(v["calibration_parity_ok"]
                                     for v in vals),
        "calibration_samples": sum(v["calibration_samples"] for v in vals),
        "n_records": sum(v["n_records"] for v in vals),
        # Worst layout: a recorder change that slows one decode path
        # must show.
        "overhead_ratio": max(v["overhead_ratio"] for v in vals),
        "forensics_parity_ok": all(v["forensics_parity_ok"] for v in vals),
        "forensics_overhead_ratio": max(v["forensics_overhead_ratio"]
                                        for v in vals),
        "layouts": layouts,
        "config": config,
        "spec_k": spec_k,
        "kv_int8": kv_int8,
        "weights_int8": weights_int8,
        "backend": dev.type,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    choices=sorted(llama.CONFIGS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="pin every prompt to this length (default: "
                         "realistic 512-1024 mix for HTTP runs, 96 "
                         "for --engine-only)")
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--max-burst", type=int, default=32)
    ap.add_argument("--open-burst", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed runs on the warm server; the summary "
                         "reports median-of-runs and the worst run")
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="seconds between request arrivals (0 = one "
                         "instantaneous burst)")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--weights-int8", action="store_true")
    ap.add_argument("--admit-wave", type=int, default=None,
                    help="cap admission waves: early waves' first "
                         "tokens stream (HTTP) / stamp TTFT (engine) "
                         "while later waves prefill")
    ap.add_argument("--engine-only", action="store_true",
                    help="bench the engine directly (no HTTP; "
                         "engine-internal TTFT)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="prefix-share workload (shared system prompt "
                         "+ unique tails): warm-vs-cold TTFT, greedy "
                         "parity, and the decode-interference report")
    ap.add_argument("--prefix-pool", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--qos", action="store_true",
                    help="multi-tenant QoS bench: background-tenant "
                         "TPOT/TTFT isolation under a hot tenant "
                         "(WFQ vs FIFO control) and preemption-by-"
                         "eviction greedy parity with the allocator "
                         "audit")
    ap.add_argument("--adapters", action="store_true",
                    help="multi-LoRA adapter-catalog bench: N-adapter "
                         "mixed-workload decode TPOT vs a single-"
                         "adapter baseline on the same engine, greedy "
                         "parity vs per-adapter sequential runs, and "
                         "the pool's addresses kept while adapters "
                         "hot-load/evict mid-traffic (combine with "
                         "--smoke for the CI-sized pass)")
    ap.add_argument("--n-adapters", type=int, default=8,
                    help="fine-tunes in the mixed workload for "
                         "--adapters (pool sized to hold them; the "
                         "churn phase registers 2x as many)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative-decoding bench: the NON-"
                         "repetitive workload with the model-backed "
                         "drafter (pipelined + sync + the honest "
                         "n-gram wash column) as the headline, plus "
                         "the repetition-heavy secondary n-gram "
                         "column and the oracle-draft ceiling; greedy "
                         "parity asserted everywhere (combine with "
                         "--smoke for the CI-sized pass)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length K for --spec")
    ap.add_argument("--occupancy", action="store_true",
                    help="high-occupancy sweep: max concurrent slots "
                         "at equal KV bytes, paged vs contiguous, with "
                         "greedy parity (combine with --smoke for the "
                         "CI-sized pass)")
    ap.add_argument("--span", action="store_true",
                    help="span-bucketed decode attention bench: "
                         "span-on vs full-view decode TPOT on the "
                         "same engine (short active conversations on "
                         "a long-max_len engine), greedy parity "
                         "asserted (combine with --smoke for the "
                         "CI-sized pass)")
    ap.add_argument("--kernel", action="store_true",
                    help="paged decode-attention kernel bench: K1 vs "
                         "its plain version, decode TPOT on the same "
                         "engine at low occupancy, greedy parity "
                         "asserted (combine with --smoke for the "
                         "CI-sized pass; with --span or --occupancy "
                         "it changes nothing: the paged engine's reads "
                         "run K1 already)")
    ap.add_argument("--flight", action="store_true",
                    help="flight recorder + compile watch bench: the "
                         "full mixed workload (chunked admission + "
                         "spec decode + span regrouping, paged) with "
                         "warm-grid startup: zero unexpected compiles "
                         "in the timed window, per-burst record "
                         "coverage, and the recorder-off no-op guard "
                         "(combine with --smoke for the CI-sized pass)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized pass of --spec, --qos, --adapters, "
                         "--flight, --occupancy, --span, --kernel or "
                         "of the prefix-share workload (regression "
                         "guard for the chunk scheduler)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default, the card) or cpu")
    args = ap.parse_args(argv)
    device = _device_kind(resolve_device(args.device))
    if args.adapters:
        r = run_adapters(config=args.config, n_adapters=args.n_adapters,
                         kv_int8=args.kv_int8,
                         weights_int8=args.weights_int8, smoke=args.smoke,
                         device=args.device)
        print(json.dumps({
            "metric": "serve_adapter_overhead",
            "value": r["overhead_ratio"],
            "unit": "x_mixed_decode_tpot_vs_single",
            **{k: r[k] for k in (
                "tpot_single_ms", "tpot_mixed_ms", "parity_ok",
                "hot_loads", "evictions", "unexpected_compiles",
                "n_adapters", "rank", "backend", "config")},
            "device": device,
        }))
        return
    if args.flight:
        r = run_flight(config=args.config, kv_int8=args.kv_int8,
                       weights_int8=args.weights_int8, smoke=args.smoke,
                       device=args.device)
        print(json.dumps({
            "metric": "serve_unexpected_compiles",
            "value": r["unexpected_compiles"],
            "unit": "programs_compiled_in_timed_window",
            **{k: r[k] for k in (
                "warmup_compile_s", "coverage_ok", "parity_ok",
                "calibration_parity_ok", "calibration_samples",
                "n_records", "overhead_ratio", "layouts", "config")},
            "device": device,
        }))
        return
    if args.span:
        r = run_span(config=args.config, kv_int8=args.kv_int8,
                     weights_int8=args.weights_int8, smoke=args.smoke,
                     device=args.device)
        print(json.dumps({
            "metric": "serve_span_speedup",
            "value": r["speedup"],
            "unit": "x_decode_tok_s_vs_full_view",
            **{k: r[k] for k in (
                "tpot_full_ms", "tpot_span_ms", "rows_full",
                "rows_span", "rows_ratio", "span_ladder",
                "n_span_programs", "parity_ok", "kv_kernel",
                "config")},
            "device": device,
        }))
        return
    if args.kernel and not args.occupancy:
        r = run_kernel(config=args.config, kv_int8=args.kv_int8,
                       weights_int8=args.weights_int8,
                       spec_k=(args.spec_k if args.spec else 0),
                       smoke=args.smoke, device=args.device)
        print(json.dumps({
            "metric": "serve_kernel_speedup",
            "value": r["speedup"],
            "unit": "x_decode_tok_s_vs_gather",
            **{k: r[k] for k in (
                "tpot_gather_ms", "tpot_kernel_ms", "parity_ok",
                "kernel_programs_ok", "backend", "active_requests",
                "slots", "span_ladder", "config")},
            "device": device,
        }))
        return
    if args.spec:
        r = run_spec(config=args.config, spec_k=args.spec_k,
                     kv_int8=args.kv_int8,
                     weights_int8=args.weights_int8, smoke=args.smoke,
                     device=args.device)
        print(json.dumps({
            "metric": "serve_spec_model_speedup",
            "value": r["model_speedup"],
            "unit": "x_decode_tok_s_vs_spec_off",
            **{k: r[k] for k in (
                "model_tpot_off_ms", "tpot_model_ms",
                "tpot_model_sync_ms", "pipeline_ratio",
                "model_accept_rate", "model_parity_ok",
                "overlap_ok", "draft_reuse_hits", "draft_layers",
                "ngram_nonrep_speedup", "ngram_nonrep_accept_rate",
                "tpot_off_ms", "tpot_spec_ms", "tpot_oracle_ms",
                "speedup", "oracle_speedup", "accept_rate",
                "oracle_accept_rate", "parity_ok",
                "oracle_parity_ok", "spec_k", "config", "backend")},
            "device": device,
        }))
        return
    if args.occupancy:
        r = run_occupancy(config=args.config, kv_int8=args.kv_int8,
                          weights_int8=args.weights_int8,
                          smoke=args.smoke, device=args.device)
        print(json.dumps({
            "metric": "serve_occupancy_x",
            "value": r["occupancy_x"],
            "unit": "x_slots_at_equal_hbm",
            **{k: r[k] for k in (
                "kv_hbm_bytes", "paged_slots", "contiguous_slots",
                "blocks_per_token", "kv_block", "parity_ok",
                "occupancy_regressed", "kv_kernel", "config")},
            "device": device,
        }))
        return
    if args.qos:
        r = run_qos(config=args.config, kv_int8=args.kv_int8,
                    weights_int8=args.weights_int8, smoke=args.smoke,
                    device=args.device)
        print(json.dumps({
            "metric": "serve_qos_fairness_ratio",
            "value": r["fairness_ratio"],
            "unit": "x_bg_tpot_p99_vs_idle",
            **{k: r[k] for k in (
                "bg_tpot_idle_p99_ms", "bg_tpot_contended_p99_ms",
                "bg_ttft_wfq_ratio", "bg_ttft_fifo_ratio",
                "sched_parity_ok", "preempt_parity_ok",
                "preemptions", "preempt_resumed_rows", "config")},
            "device": device,
        }))
        return
    if args.smoke or args.prefix_share:
        if args.smoke:
            r = run_smoke(device=args.device)
        else:
            r = run_prefix_share(
                config=args.config, requests=args.requests,
                slots=args.slots, new_tokens=args.new_tokens,
                max_burst=args.max_burst,
                prefill_chunk=args.prefill_chunk,
                prefix_pool=args.prefix_pool,
                kv_int8=args.kv_int8, weights_int8=args.weights_int8,
                device=args.device)
        print(json.dumps({
            "metric": "serve_prefix_warm_ttft",
            "value": r["warm_ttft_ms"],
            "unit": "ms",
            "cold_ttft_ms": r["cold_ttft_ms"],
            "warm_speedup": r["warm_speedup"],
            "parity_ok": r["parity_ok"],
            "hit_rate": r["hit_rate"],
            "decode_stall_p99_ms": r["decode_stall_p99_ms"],
            "interference": r["interference"],
            "config": r["config"],
            "device": device,
        }))
        return
    if args.engine_only:
        r = run(config=args.config, requests=args.requests,
                slots=args.slots, prompt_len=args.prompt_len or 96,
                new_tokens=args.new_tokens, max_burst=args.max_burst,
                kv_int8=args.kv_int8, weights_int8=args.weights_int8,
                admit_wave=args.admit_wave, device=args.device)
    else:
        r = run_http(config=args.config, requests=args.requests,
                     slots=args.slots, prompt_len=args.prompt_len,
                     new_tokens=args.new_tokens,
                     max_burst=args.max_burst, kv_int8=args.kv_int8,
                     weights_int8=args.weights_int8,
                     admit_wave=args.admit_wave,
                     open_burst=args.open_burst,
                     repeats=args.repeats, stagger_s=args.stagger,
                     device=args.device)
    out = {
        "metric": "serve_median_ttft",
        "value": r["median_ttft_ms"],
        "unit": "ms",
        "vs_baseline": r["vs_baseline_ttft"],
        "output_tok_per_s": r["out_tok_s"],
        "req_per_s": r["req_per_s"],
        "config": r["config"],
        "kv_int8": r["kv_int8"],
        "weights_int8": r["weights_int8"],
    }
    if "p99_ttft_ms" in r:
        out["p99_ttft_ms"] = r["p99_ttft_ms"]
        out["transport"] = r["transport"]
    out["device"] = device
    print(json.dumps(out))


if __name__ == "__main__":
    main()
