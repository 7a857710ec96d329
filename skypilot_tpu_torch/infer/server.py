"""HTTP model server: the continuous-batching engine behind a stdlib
server.

Counterpart of ``skypilot_tpu/infer/server.py`` for the routes a
replica serves in this slice of the port, with the reference's request
and response JSON keys:

  GET  /health              -> 200 {"status": "ok"} once warm,
                               503 {"status": "warming"} before
  POST /generate            {"tokens": [...], "max_new_tokens": N}
                            -> {"tokens": [...], "ttft_ms": ..., ...}
  POST /generate + "stream": true
                            -> Transfer-Encoding: chunked, one JSON
                               line per emission ({"tokens": [...]}),
                               closing line {"done": true, ...}
  POST /prefill             {"tokens": [...], "max_new_tokens": N}
                            -> {"committed": [t], "export": {...}, ...}
                               (409 {"type": "handoff_ineligible"})
  POST /handoff             {"tokens", "committed", "export",
                             "max_new_tokens"[, "stream"]} -> as
                            /generate, the committed tokens first

``/prefill`` and ``/handoff`` are the two tiers of the reference's
disaggregated serving, driven by its load balancer: a prefill-tier
replica runs the prompt to one committed token and exports the stored
prefix's KV blocks (:func:`encode_export`, the reference's wire form); a
decode-tier replica imports them (:func:`decode_export`) and resumes
the prompt plus the committed token through its prefix cache. A port
replica serves either tier, beside the reference's replicas.

A prompt longer than the largest bucket gets HTTP 400 with the
reference's typed body (``PromptTooLongError.typed_error``). Prompts
longer than ``--prefill-chunk`` (512) prefill in chunks, one chunk
between decode bursts; the trailer's ``prefill_chunks`` counts them.
The reference server's other two defaults are on as well: a prefix
cache of ``--prefix-pool`` (8) shared prompt prefixes (trailer:
``cache_hit``, ``cached_tokens``) and n-gram speculation at ``--spec-k``
(4) draft tokens (trailer: ``spec_drafted``, ``spec_accepted``,
``drafter``); ``SKYTPU_PREFIX_POOL`` and ``SKYTPU_SPEC_K`` set the
defaults, the flags win. ``--kv-int8 --weights-int8`` serve the
reference's int8 recipe (``llm/serve-8b-w8a8.yaml``): an int8 KV cache
and w8a8 weights. ``--open-burst``, ``--open-window`` and ``--coalesce``
are the reference's burst and admission-coalescing knobs, so the
recipe's command line runs as it stands.

    python -m skypilot_tpu_torch.infer.server --config llama3-8b
    python -m skypilot_tpu_torch.infer.server --config llama3-8b \
        --kv-int8 --weights-int8

serves greedy decoding on the CUDA card (``--device cpu`` runs the
plain PyTorch versions on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from socketserver import ThreadingMixIn
from typing import Dict, Optional

import torch

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.infer import engine as eng
from skypilot_tpu_torch.models import llama


class _Pending:
    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[Dict] = None
        self.enqueued_s = time.time()
        self.stream = False
        # Streaming: the loop pushes token batches as decoded
        # ({"tokens": [...]}); a {"done"/"error"} dict terminates.
        self.req: Optional[eng.Request] = None
        self.cursor = 0           # tokens already pushed to the stream
        self.chunks: queue.Queue = queue.Queue()
        # /prefill: the finished pass attaches the retired request's
        # stored-prefix export to the result.
        self.export_prefix = False


class ModelServer:
    """Engine + request inbox + batching loop.

    The loop thread is the ONLY thread that touches the engine. Handler
    threads drop (tokens, pending) into an inbox under a small lock and
    wait on their pending's event or chunk queue.
    """

    def __init__(self, engine: eng.InferenceEngine, max_burst: int = 8,
                 open_burst: int = 4, open_window_s: float = 1.0,
                 coalesce_s: float = 0.012):
        self.engine = engine
        self.max_burst = max_burst
        # Admission coalescing: when the inbox yields less than a full
        # wave but a request arrived within ``coalesce_s``, wait a beat
        # (2 ms slices, re-draining) so a burst of arrivals shares one
        # wave instead of splitting into several.
        self.coalesce_s = coalesce_s
        # Burst length while free slots exist and traffic is arriving:
        # a late arrival waits at most one short burst for its prefill.
        # Full bursts run when every slot is busy or no request arrived
        # for ``open_window_s``.
        self.open_burst = min(open_burst, max_burst)
        self.open_window_s = open_window_s
        self._last_arrival = 0.0      # guarded-by: _inbox_lock
        # Double-buffered decode: burst k+1 is dispatched before burst
        # k's tokens are fetched and streamed. Speculative engines run
        # the synchronous path instead: the next verify round's window
        # needs the tokens this one commits, and decode_burst routes to
        # the verify round there.
        self._burst: Optional[eng.BurstHandle] = None
        self._async_decode = not engine.spec_k
        self._inbox_lock = threading.Lock()
        self._inbox: list = []        # guarded-by: _inbox_lock
        self._pending: Dict[int, _Pending] = {}   # loop-thread only
        self._ready = threading.Event()
        self._stop = threading.Event()
        self.warmup_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _add(self, tokens, max_new_tokens: int, stream: bool = False,
             export_prefix: bool = False,
             handoff: Optional[Dict] = None) -> _Pending:
        # Validate eagerly (oversized prompt -> clean 400) without
        # touching the engine's mutable state from this thread.
        eng._bucket(len(tokens), self.engine.buckets)
        p = _Pending()
        p.stream = stream
        p.export_prefix = export_prefix
        with self._inbox_lock:
            self._inbox.append((list(tokens), max_new_tokens, p, handoff))
            self._last_arrival = time.monotonic()
        return p

    def submit(self, tokens, max_new_tokens: int,
               export_prefix: bool = False,
               handoff: Optional[Dict] = None) -> Dict:
        """Blocking: the result dict once the request finishes.
        ``export_prefix`` (``/prefill``) adds the engine's prefix export
        under ``"export"`` (None when none is resident); ``handoff``
        (``/handoff``: ``{"committed": [...], "export": {...} or None}``)
        imports the export and resumes after the committed tokens."""
        p = self._add(tokens, max_new_tokens, export_prefix=export_prefix,
                      handoff=handoff)
        t0 = time.time()
        p.event.wait()
        out = dict(p.result or {})
        out["total_ms"] = round((time.time() - t0) * 1e3, 2)
        return out

    def submit_stream(self, tokens, max_new_tokens: int,
                      handoff: Optional[Dict] = None):
        """Iterator of chunk dicts: {"tokens": [...]} as decoded, then
        one {"done": true, "ttft_ms": ...} (or {"error": ...}).
        Validation happens before any bytes are written, so an
        oversized prompt raises here as a clean 400. ``handoff`` as in
        :meth:`submit`; the committed tokens stream first."""
        p = self._add(tokens, max_new_tokens, stream=True, handoff=handoff)

        def gen():
            while True:
                chunk = p.chunks.get()
                yield chunk
                if "done" in chunk or "error" in chunk:
                    return

        return gen()

    def wait_ready(self, timeout: float) -> None:
        """Block until warm; raise the warmup's error, or on timeout."""
        deadline = time.monotonic() + timeout
        while not self._ready.wait(timeout=0.5):
            if self.warmup_error is not None:
                raise RuntimeError("model server warmup failed") \
                    from self.warmup_error
            if time.monotonic() > deadline:
                raise TimeoutError(f"model server not warm after "
                                   f"{timeout} s")

    def _loop(self) -> None:
        # Warm up before /health flips: the first call pays the kernel
        # build. A failed warmup (a kernel that does not build or
        # launch) stops the loop with /health at 503 and the error kept
        # in ``warmup_error``.
        try:
            self.engine.generate([[1]], max_new_tokens=2)
        except Exception as e:  # noqa: BLE001 — reported, then stop
            self.warmup_error = e
            print(f"model server warmup failed: {e!r}", file=sys.stderr,
                  flush=True)
            return
        self.engine.finished.clear()
        self._ready.set()
        while not self._stop.is_set():
            try:
                busy = self._step()
            except Exception as e:  # noqa: BLE001 — fail the in-flight
                # requests loudly; never let the serving thread die
                # while /health reports ok. The engine's slot state is
                # reset so later requests do not re-drive the poisoned
                # ones; if even the reset fails the card is gone and
                # /health turns 503.
                self._burst = None
                try:
                    self.engine.reset()
                except Exception:  # noqa: BLE001
                    self._ready.clear()
                for p in self._pending.values():
                    p.result = {"error": f"engine failure: {e!r}"}
                    if p.stream:
                        p.chunks.put({"error": p.result["error"]})
                    p.event.set()
                self._pending.clear()
                busy = False
            if not busy:
                time.sleep(0.002)

    def _drain_inbox(self) -> None:
        with self._inbox_lock:
            new, self._inbox = self._inbox, []
        for tokens, max_new, p, handoff in new:
            committed = None
            if handoff is not None:
                # Decode tier: install the prefill tier's blocks here
                # (the loop thread is the engine's only user), then
                # admit prompt + committed through the resume path. A
                # failed or skipped import resumes cold, with the same
                # tokens: never an error.
                committed = list(handoff.get("committed") or [])
                export = handoff.get("export")
                if export is not None:
                    try:
                        self.engine.import_prefix(
                            list(tokens) + committed, export,
                            salt=export.get("salt", b""))
                    except Exception as e:  # noqa: BLE001 — cold resume
                        print(f"model server: handoff import failed, "
                              f"resuming cold: {e!r}", file=sys.stderr,
                              flush=True)
            rid = self.engine.add_request(tokens, max_new,
                                          committed=committed)
            p.req = self.engine.waiting[-1]
            # TTFT counts from when the handler enqueued the request.
            p.req.submit_s = p.enqueued_s
            self._pending[rid] = p

    def _flush_streams(self) -> None:
        """Push newly decoded tokens to every pending stream (diffs
        req.tokens against the cursor)."""
        for p in self._pending.values():
            if p.req is None or not p.stream:
                continue
            new = p.req.tokens[p.cursor:]
            if new:
                p.cursor += len(new)
                p.chunks.put({"tokens": list(new)})

    def _on_wave(self) -> None:
        # After each admission wave: stream its first tokens, then pull
        # requests that arrived during the wave's prefill into this
        # admission pass.
        self._flush_streams()
        self._drain_inbox()

    def _complete_burst(self) -> None:
        if self._burst is not None:
            handle, self._burst = self._burst, None
            self.engine.complete_decode_burst(handle)
            self._flush_streams()

    def _step(self) -> bool:
        self._drain_inbox()
        e = self.engine
        if not (e.waiting or e.slot_req or e.chunking
                or self._burst is not None):
            return False
        if e.waiting and e.free_slots:
            target = min(e.max_wave or len(e.free_slots),
                         len(e.free_slots))
            deadline = time.monotonic() + self.coalesce_s
            while (len(e.waiting) < target
                   and time.monotonic() < deadline
                   and time.monotonic() - self._last_arrival
                   < self.coalesce_s):
                time.sleep(0.002)
                self._drain_inbox()
        # Admission has priority over decode, but it needs accurate
        # slot state: the outstanding burst lands first (its
        # retirements may free the slots admission wants).
        if e.waiting:
            self._complete_burst()
            if e.free_slots:
                e.admit(on_wave=self._on_wave)
                self._flush_streams()
        if e.chunking:
            # Chunk -> decode alternation: the outstanding burst lands,
            # ONE prefill chunk runs, then the next burst is dispatched
            # below, so a long prompt stalls the decoding slots for one
            # chunk at a time. The final chunk emits a first token.
            self._complete_burst()
            e.prefill_chunk_step()
            self._flush_streams()
        if e.slot_req:
            quiet = (time.monotonic() - self._last_arrival
                     > self.open_window_s)
            # While a chunked prefill is in flight bursts stay short:
            # the alternation's granularity bounds its TTFT.
            k = (self.max_burst
                 if (not e.free_slots or quiet) and not e.chunking
                 else self.open_burst)
            if self._async_decode:
                nxt = e.dispatch_decode_burst(max_burst=k)
                self._complete_burst()
                self._burst = nxt
            else:
                e.decode_burst(max_burst=k)
                self._flush_streams()
        else:
            self._complete_burst()
        for req in e.finished:
            p = self._pending.pop(req.rid, None)
            if p is None:
                continue
            ttft = ((req.first_token_s - req.submit_s) * 1e3
                    if req.first_token_s is not None else None)
            ttft = round(ttft, 2) if ttft is not None else None
            # The reference trailer's keys; the features behind the
            # zero-valued ones (QoS, recovery, adapters) are later
            # slices.
            stats = {"cache_hit": bool(req.cached_len),
                     "cached_tokens": req.cached_len,
                     "spec_drafted": req.spec_drafted,
                     "spec_accepted": req.spec_accepted,
                     "drafter": req.spec_mode or "off",
                     "preemptions": 0, "recoveries": 0}
            p.result = {"tokens": req.tokens, "ttft_ms": ttft,
                        "prefill_chunks": req.n_chunks, "model": None,
                        **stats}
            if p.export_prefix:
                # /prefill: the stored prefix stays a ref-counted LRU
                # resident here, so a lost handoff leaks nothing; None
                # when it was evicted before the request retired.
                p.result["export"] = e.export_prefix_for(req)
            if p.stream:
                p.chunks.put({"done": True, "ttft_ms": ttft,
                              "n_tokens": len(req.tokens), **stats})
            p.event.set()
        e.finished.clear()
        return True

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def encode_export(export: Dict) -> Dict:
    """JSON-safe wire form of an engine prefix export (the /prefill
    response body's ``export`` field): block tensors as base64 raw
    bytes + shape/dtype, the adapter salt as base64. bfloat16 scale
    planes widen to float32 on the wire (exact, and the receiver's
    scatter casts back), so every wire dtype is plain numpy."""
    import base64

    import numpy as np
    tensors = {}
    for name, arr in export["tensors"].items():
        arr = np.ascontiguousarray(arr)
        if str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        tensors[name] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "data": base64.b64encode(arr.tobytes()).decode()}
    return {"cached_len": int(export["cached_len"]),
            "kv_block": int(export["kv_block"]),
            "n_blocks": int(export["n_blocks"]),
            "salt": base64.b64encode(export.get("salt")
                                     or b"").decode(),
            "tensors": tensors}


def decode_export(wire: Dict) -> Dict:
    """Inverse of :func:`encode_export` — the dict
    ``InferenceEngine.import_prefix`` consumes. Raises ValueError /
    KeyError / TypeError on malformed wire payloads (the /handoff
    handler maps those to a 400)."""
    import base64

    import numpy as np
    tensors = {}
    for name, spec in wire["tensors"].items():
        arr = np.frombuffer(
            base64.b64decode(spec["data"]),
            dtype=np.dtype(str(spec["dtype"]))).reshape(
                [int(d) for d in spec["shape"]])
        tensors[str(name)] = arr
    return {"cached_len": int(wire["cached_len"]),
            "kv_block": int(wire["kv_block"]),
            "n_blocks": int(wire["n_blocks"]),
            "salt": base64.b64decode(wire.get("salt") or ""),
            "tensors": tensors}


class _Threading(ThreadingMixIn, HTTPServer):
    daemon_threads = True
    # A burst of concurrent clients overflows the default listen
    # backlog of 5 -> connection resets under load.
    request_queue_size = 128


def make_handler(model: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                if model._ready.is_set():
                    return self._json(200, {"status": "ok"})
                return self._json(503, {"status": "warming"})
            return self._json(404, {"error": "not found"})

        def _stream(self, chunks):
            """Chunked NDJSON: tokens flow as the engine decodes them."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for chunk in chunks:
                    data = json.dumps(chunk).encode() + b"\n"
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.write(b"0\r\n\r\n")
            except ConnectionError:
                return        # client went away mid-stream

        def do_POST(self):
            if "chunked" in (self.headers.get("Transfer-Encoding")
                             or "").lower():
                # No Content-Length: the body cannot be read, and an
                # unread body would corrupt the next keep-alive request.
                self.close_connection = True
                return self._json(411, {"error": {
                    "type": "length_required",
                    "message": "chunked request bodies are not "
                               "supported; send Content-Length"}})
            length = int(self.headers.get("Content-Length") or 0)
            body_bytes = self.rfile.read(length)
            if self.path not in ("/generate", "/prefill", "/handoff"):
                return self._json(404, {"error": "not found"})
            try:
                body = json.loads(body_bytes or b"{}")
                tokens = [int(t) for t in body["tokens"]]
                max_new = int(body.get("max_new_tokens", 64))
                stream = bool(body.get("stream", False))
            except (ValueError, TypeError, KeyError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            if self.path == "/prefill":
                return self._prefill(tokens, max_new)
            handoff = None
            if self.path == "/handoff":
                # Decode tier: import the prefill tier's blocks, then
                # resume prompt + committed; the committed tokens
                # stream first (cursor 0), so the client's TTFT is the
                # prefill tier's.
                try:
                    handoff = {
                        "committed": [int(t) for t in
                                      body.get("committed") or []],
                        "export": (decode_export(body["export"])
                                   if body.get("export") else None)}
                except (ValueError, TypeError, KeyError) as e:
                    return self._json(400,
                                      {"error": f"bad handoff: {e}"})
            try:
                if stream:
                    return self._stream(model.submit_stream(
                        tokens, max_new, handoff=handoff))
                out = model.submit(tokens, max_new, handoff=handoff)
            except eng.PromptTooLongError as e:
                return self._json(400, {"error": e.typed_error})
            if "error" in out:
                return self._json(500, out)
            return self._json(200, out)

        def _prefill(self, tokens, max_new):
            """Prefill tier: run the request to ONE committed token and
            return it with the stored prefix's export; the load
            balancer hands both to a decode replica. A request that
            cannot hand off, or whose prefix was evicted before the
            export, gets the typed 409 the balancer answers by serving
            it single-tier."""
            if not model.engine.handoff_eligible(tokens, max_new):
                return self._json(409, {"error": {
                    "type": "handoff_ineligible",
                    "message": "request cannot hand off (prompt "
                               "shorter than one prefill chunk, "
                               "single-token budget, or prefix "
                               "cache off); route single-tier"}})
            try:
                out = model.submit(tokens, 1, export_prefix=True)
            except eng.PromptTooLongError as e:
                return self._json(400, {"error": e.typed_error})
            if "error" in out:
                return self._json(500, out)
            export = out.pop("export", None)
            if export is None:
                return self._json(409, {"error": {
                    "type": "handoff_ineligible",
                    "message": "prefix evicted before export "
                               "(pool pressure); route single-tier"}})
            out["committed"] = out.pop("tokens")
            out["export"] = encode_export(export)
            return self._json(200, out)

        def log_message(self, *a):
            pass

    return Handler


def serve(engine: eng.InferenceEngine, host: str = "0.0.0.0",
          port: int = 8080, max_burst: int = 8, open_burst: int = 4,
          open_window_s: float = 1.0, coalesce_s: float = 0.012):
    model = ModelServer(engine, max_burst=max_burst, open_burst=open_burst,
                        open_window_s=open_window_s, coalesce_s=coalesce_s)
    httpd = _Threading((host, port), make_handler(model))
    return model, httpd


def make_engine(config: str, slots: int = 16, max_len: int = 1024,
                admit_wave: int = 8, kv_block: int = 256,
                prefill_chunk: int = 512, prefix_pool: int = 8,
                spec_k: int = 4, kv_int8: bool = False,
                weights_int8: bool = False, device: DeviceLike = None,
                seed: int = 0) -> eng.InferenceEngine:
    """The serving engine ``main()`` runs: ``config``'s model with
    random weights drawn in ``cfg.dtype`` on ``device`` from ``seed``,
    greedy decoding, paged KV, prompt buckets (128, 512, max_len),
    chunked prefill above ``prefill_chunk`` tokens, a prefix cache of
    ``prefix_pool`` entries and ``spec_k``-token n-gram speculation (0
    disables each), the reference server's defaults. ``kv_int8``: an
    int8 KV cache; ``weights_int8``: w8a8 weights, quantized once on
    ``device`` from the drawn weights, whose float copies are then
    dropped."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[config]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = llama.init_params(cfg, gen, device=dev, dtype=cfg.dtype)
    buckets = tuple(sorted({min(128, max_len), min(512, max_len),
                            max_len}))
    engine = eng.InferenceEngine(
        params, cfg, n_slots=slots, max_len=max_len,
        prompt_buckets=buckets, max_wave=admit_wave, kv_block=kv_block,
        prefill_chunk=prefill_chunk, prefix_pool=prefix_pool,
        spec_k=spec_k, kv_int8=kv_int8, weights_int8=weights_int8,
        device=dev, seed=seed)
    # Under weights_int8 the engine keeps only the slim tree; this
    # reference must go too, or the float block matrices stay resident.
    del params
    return engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="llama3-8b",
                    choices=sorted(llama.CONFIGS))
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--max-burst", type=int, default=8,
                    help="decode tokens per device call")
    ap.add_argument("--open-burst", type=int, default=4,
                    help="decode burst while free slots remain AND "
                         "traffic arrived within --open-window — keeps "
                         "late arrivals from waiting out a full burst "
                         "before their prefill")
    ap.add_argument("--open-window", type=float, default=1.0,
                    help="seconds since the last arrival during which "
                         "bursts stay short when slots are free; after "
                         "a quiet spell bursts go long (dispatch "
                         "amortization on a partially loaded server)")
    ap.add_argument("--admit-wave", type=int, default=8,
                    help="admission wave cap (0 = uncapped)")
    ap.add_argument("--coalesce", type=float, default=0.012,
                    help="seconds to wait for a filling admission wave "
                         "when the newest arrival is fresher than this "
                         "(prevents 1-row waves on bursts)")
    ap.add_argument("--kv-block", type=int, default=256,
                    help="paged KV cache block length")
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="prefill prompts longer than this in chunks of "
                         "this many tokens between decode bursts "
                         "(0 = off)")
    ap.add_argument("--prefix-pool", type=int,
                    default=int(os.environ.get("SKYTPU_PREFIX_POOL", "8")
                                or 0),
                    help="prefix KV cache: resident prompt prefixes, kept "
                         "as shared blocks, for suffix-only prefill "
                         "(0 = off; default env SKYTPU_PREFIX_POOL or 8)")
    ap.add_argument("--spec-k", type=int,
                    default=int(os.environ.get("SKYTPU_SPEC_K", "4")
                                or 0),
                    help="speculative decoding: n-gram draft tokens per "
                         "slot verified in one round (0 = off; default "
                         "env SKYTPU_SPEC_K or 4)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache: int8 rows with a bfloat16 scale "
                         "per row and kv-head")
    ap.add_argument("--weights-int8", action="store_true",
                    help="w8a8: int8 block matrices and head, int8 "
                         "activations per token")
    ap.add_argument("--device", default=None,
                    help="cuda (the default, the card) or cpu")
    args = ap.parse_args(argv)
    engine = make_engine(args.config, slots=args.slots,
                         max_len=args.max_len, admit_wave=args.admit_wave,
                         kv_block=args.kv_block,
                         prefill_chunk=args.prefill_chunk,
                         prefix_pool=args.prefix_pool,
                         spec_k=args.spec_k, kv_int8=args.kv_int8,
                         weights_int8=args.weights_int8, device=args.device)
    model, httpd = serve(engine, port=args.port, max_burst=args.max_burst,
                         open_burst=args.open_burst,
                         open_window_s=args.open_window,
                         coalesce_s=args.coalesce)
    print(json.dumps({"event": "server.listening", "port": args.port,
                      "device": str(engine.device)}), file=sys.stderr,
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        model.shutdown()


if __name__ == "__main__":
    main()
