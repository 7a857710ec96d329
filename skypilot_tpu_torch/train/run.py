"""Training entry point: ``python -m skypilot_tpu_torch.train.run``.

Counterpart of ``skypilot_tpu/train/run.py`` for dense Llama on one
card. Examples::

    # llama3-1b, full width and depth, on the card
    python -m skypilot_tpu_torch.train.run --config llama3-1b --steps 100

    # tiny, on the CPU (the plain kernel versions), with checkpoints
    python -m skypilot_tpu_torch.train.run --device cpu \\
        --config llama3-tiny --steps 4 --seq 64 --ckpt-dir /tmp/c

The loop follows the JAX one: warmup ``max(1, min(100, steps // 10))``
of ``steps``, the same synthetic batch every step unless ``--packed``
(then packed variable-length documents with segment masking), a
checkpoint every ``--ckpt-every`` steps, and a forced final save that
is waited for. Per-step logs go to stderr; the last stdout line is one
JSON object with ``final_loss``, ``steps``, ``wall_s``,
``tokens_per_sec``, ``tokens_per_sec_per_chip``, ``goodput`` and
``mesh`` (``{}``: one card, no mesh). Not in this slice: LoRA/QLoRA,
MoE and pipeline models and the mesh flags.

Observed as the reference's loop is: the trainer's compile watch
(``train.unexpected_compile`` after the first step) with sampled
device-time calibration (CUDA events on the card), the goodput ledger
(``observability/goodput.py``: per-step ``train_step`` flight records
whose phases sum to the step's wall, cumulative buckets whose stamps
persist beside the checkpoints as ``goodput.json`` and fold in on
``--resume``), the anomaly watchdog over the fetched losses, the
checkpoint families and spans, ``sky_callback`` step summaries and,
with ``SKYTPU_TIMELINE_FILE_PATH`` set, Perfetto spans.
``SKYTPU_GOODPUT=0`` turns the ledger off and leaves the loop as it
was. One deliberate difference: at a step whose loss the logging
cadence fetches, ``compute`` ends on the step's completion (a CUDA
event recorded after the step and waited on inside the phase), so the
device tail lands in ``compute`` instead of the ``eval`` fetch
(``observability/goodput.py``'s docstring).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from skypilot_tpu_torch import resolve_device


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drain(device: torch.device) -> None:
    """Wait for the work enqueued so far on the current stream: a CUDA
    event recorded now, then waited on by the host."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the loop; prints the summary line and also returns it, with
    the logged ``losses`` and ``step_ms`` (the wall time per step
    between logging syncs), the goodput ledger's ``train_step``
    ``records`` and its final ``snapshot`` added."""
    ap = argparse.ArgumentParser(prog="python -m skypilot_tpu_torch.train.run")
    ap.add_argument("--model", default="llama", choices=("llama",))
    ap.add_argument("--config", default="llama3-400m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--xent-chunk", type=int, default=None,
                    help="chunked cross-entropy: the [B,S,vocab] logits "
                         "never exist at once (0 = unchunked)")
    ap.add_argument("--packed", action="store_true",
                    help="packed-sequence input (segment-masked "
                         "attention) over synthetic variable-length docs")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import skypilot_tpu_torch.callbacks as sky_callback
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.observability import attribution, flight
    from skypilot_tpu_torch.observability import goodput as goodput_lib
    from skypilot_tpu_torch.train import checkpoints, trainer

    device = resolve_device(args.device)
    cfg = llama.CONFIGS[args.config]
    if args.xent_chunk is not None:
        cfg = dataclasses.replace(cfg, xent_chunk=args.xent_chunk)
    args.seq = min(args.seq, cfg.max_seq_len)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"device: {device} ({name}); {args.config} "
        f"{cfg.num_params():,} params, batch {args.batch} x seq {args.seq}")
    tc = trainer.TrainConfig(learning_rate=args.lr,
                             warmup_steps=max(1, min(100, args.steps // 10)),
                             total_steps=args.steps)
    # Goodput forensics: the trainer's own compile watch (a new program
    # key after the first step is a typed train.unexpected_compile),
    # sampled device-time calibration, the per-step phase ledger and
    # the anomaly watchdog over the losses the logging cadence fetches
    # anyway. The roofline peaks are published for the train MFU.
    peak_f, peak_bw = attribution.device_peaks(device)
    attribution.ROOFLINE_PEAK_FLOPS.set(peak_f)
    attribution.ROOFLINE_PEAK_BW.set(peak_bw)
    watch = flight.CompileWatch(event_name="train.unexpected_compile")
    watch.calibrator = attribution.DeviceTimeCalibrator(device=device)
    gp = goodput_lib.GoodputRecorder(
        param_count=cfg.num_params(), watch=watch,
        calibrator=watch.calibrator)
    watchdog = goodput_lib.AnomalyWatchdog(goodput=gp)
    step_fn = trainer.make_train_step(cfg, tc, watch=watch)

    mgr = checkpoints.CheckpointManager(args.ckpt_dir) \
        if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        gp.load_stamps(mgr.directory)
        with gp.account("restart_replay"):
            state = mgr.restore(device=device)
        start_step = int(state["step"])
        log(f"resumed from step {start_step}")
    else:
        with gp.account("warmup_compile"):
            state = trainer.create_train_state(cfg, tc, device)

    batches = None
    batch_data = None
    if args.packed:
        def batch_stream():
            seed = 0
            while True:
                docs = ip.synthetic_doc_stream(
                    256, cfg.vocab_size, mean_len=args.seq // 3, seed=seed)
                yield from ip.packed_batches(docs, args.batch, args.seq)
                seed += 1

        batches = ip.prefetch(batch_stream(), device=device)
    else:
        batch_data = trainer.synthetic_batch(cfg, args.batch, args.seq,
                                             device=device)
    try:
        if start_step >= args.steps:
            log(f"checkpoint already at step {start_step}; nothing to "
                f"train")
            out = {"steps": 0, "resumed_step": start_step, "mesh": {}}
            print(json.dumps(out))
            return out
        losses: List[float] = []
        step_ms: List[float] = []
        records: List[Dict[str, Any]] = []
        sky_callback.init(total_steps=args.steps)
        _sync(device)
        t0 = t_log = time.time()
        last_logged = start_step
        metrics = None
        for step in range(start_step, args.steps):
            fetch = (step + 1) % args.log_every == 0 \
                or step + 1 == args.steps
            gp.step_start(step)
            if batches is not None:
                with gp.phase("data_wait"):
                    batch_data = next(batches)
            with sky_callback.step():
                with gp.phase("compute"):
                    state, metrics = step_fn(state, batch_data)
                    if fetch and gp.enabled:
                        # The device tail: the sync the fetch below
                        # would pay lands here (module docstring).
                        _drain(device)
            if step == start_step:
                # Every program the loop can reach has run now; from
                # here a new key is a mid-run first dispatch.
                watch.declare_warm()
            loss = grad_norm = None
            if fetch:
                with gp.phase("eval"):
                    # The deliberate host fetch: the sync the timing
                    # uses; grad_norm rides the same sync.
                    loss = float(metrics["loss"])
                    grad_norm = float(metrics["grad_norm"])
                    trainer.observe_loss(loss)
                now = time.time()
                per = (now - t_log) * 1e3 / (step + 1 - last_logged)
                t_log, last_logged = now, step + 1
                losses.append(loss)
                step_ms.append(per)
                anomaly = watchdog.observe(step + 1, loss, grad_norm)
                if anomaly:
                    log(f"step {step + 1}: train.anomaly "
                        f"{anomaly['kind']} {anomaly}")
                log(f"step {step + 1}/{args.steps} loss={loss:.4f} "
                    f"grad_norm={grad_norm:.4f} ms/step={per:.1f}")
            if mgr and (step + 1) % args.ckpt_every == 0:
                with gp.phase("ckpt_save"):
                    mgr.save(step + 1, state)
                    gp.persist(mgr.directory)
            rec = gp.step_end(tokens=trainer.batch_tokens(batch_data),
                              loss=loss, grad_norm=grad_norm)
            if rec is not None:
                records.append(rec)
        loss = float(metrics["loss"])
        _sync(device)
        wall = time.time() - t0
        if mgr:
            with gp.account("ckpt_stall"):
                if mgr.latest_step() != args.steps:
                    mgr.save(args.steps, state, force=True)
                mgr.wait()
            gp.persist(mgr.directory)
    finally:
        if batches is not None:
            batches.close()
        if mgr:
            mgr.close()
    snap = gp.snapshot()
    tokens_per_s = args.batch * args.seq * (args.steps - start_step) / wall
    out = {
        "final_loss": round(loss, 4),
        "steps": args.steps - start_step,
        "wall_s": round(wall, 2),
        "tokens_per_sec": round(tokens_per_s, 1),
        "tokens_per_sec_per_chip": round(tokens_per_s, 1),
        "goodput": round(snap["goodput_ratio"], 4),
        "mesh": {},
    }
    print(json.dumps(out), flush=True)
    return dict(out, losses=losses, step_ms=step_ms, records=records,
                snapshot=snap)


if __name__ == "__main__":
    main()
