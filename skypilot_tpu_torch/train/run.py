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
``tokens_per_sec``, ``tokens_per_sec_per_chip`` and ``mesh`` (``{}``:
one card, no mesh). Not in this slice: LoRA/QLoRA, MoE and pipeline
models, the mesh flags and the goodput ledger.
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


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the loop; prints the summary line and also returns it, with
    the logged ``losses`` and ``step_ms`` (the wall time per step
    between logging syncs) added."""
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

    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.models import llama
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
    step_fn = trainer.make_train_step(cfg, tc)

    mgr = checkpoints.CheckpointManager(args.ckpt_dir) \
        if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume and mgr.latest_step() is not None:
        state = mgr.restore(device=device)
        start_step = int(state["step"])
        log(f"resumed from step {start_step}")
    else:
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
        _sync(device)
        t0 = t_log = time.time()
        last_logged = start_step
        metrics = None
        for step in range(start_step, args.steps):
            if batches is not None:
                batch_data = next(batches)
            state, metrics = step_fn(state, batch_data)
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                # The deliberate host fetch: the sync the timing uses.
                loss = float(metrics["loss"])
                now = time.time()
                per = (now - t_log) * 1e3 / (step + 1 - last_logged)
                t_log, last_logged = now, step + 1
                losses.append(loss)
                step_ms.append(per)
                log(f"step {step + 1}/{args.steps} loss={loss:.4f} "
                    f"grad_norm={float(metrics['grad_norm']):.4f} "
                    f"ms/step={per:.1f}")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state)
        loss = float(metrics["loss"])
        _sync(device)
        wall = time.time() - t0
        if mgr:
            if mgr.latest_step() != args.steps:
                mgr.save(args.steps, state, force=True)
            mgr.wait()
    finally:
        if batches is not None:
            batches.close()
        if mgr:
            mgr.close()
    tokens_per_s = args.batch * args.seq * (args.steps - start_step) / wall
    out = {
        "final_loss": round(loss, 4),
        "steps": args.steps - start_step,
        "wall_s": round(wall, 2),
        "tokens_per_sec": round(tokens_per_s, 1),
        "tokens_per_sec_per_chip": round(tokens_per_s, 1),
        "mesh": {},
    }
    print(json.dumps(out), flush=True)
    return dict(out, losses=losses, step_ms=step_ms)


if __name__ == "__main__":
    main()
