"""Evaluation: loss / perplexity / accuracy over a batch stream.

``python -m skypilot_tpu_torch.train.evaluate [--model llama|moe]
--ckpt-dir ... [--packed]`` restores the latest checkpoint's parameters
and prints one JSON line of aggregate metrics. Counterpart of
``skypilot_tpu/train/evaluate.py``; ``--config`` defaults to
llama3-400m, or moe-small with ``--model moe``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Callable, Dict, Iterable, List, Optional

import torch


def evaluate(loss_fn: Callable, params,
             batches: Iterable[Dict]) -> Dict[str, float]:
    """Token-weighted loss/accuracy over ``batches``.

    ``loss_fn(params, batch) -> (loss, metrics)`` is the model's loss
    with its config bound; it runs under ``torch.no_grad``."""
    total_loss = total_tokens = total_correct = 0.0
    n_batches = 0
    with torch.no_grad():
        for batch in batches:
            loss, metrics = loss_fn(params, batch)
            tokens = float(metrics.get("tokens", 1.0))
            total_loss += float(loss) * tokens
            total_correct += float(metrics.get("accuracy", 0.0)) * tokens
            total_tokens += tokens
            n_batches += 1
    if total_tokens == 0:
        return {"loss": float("nan"), "perplexity": float("nan"),
                "accuracy": float("nan"), "tokens": 0, "batches": 0}
    loss = total_loss / total_tokens
    return {
        "loss": round(loss, 6),
        "perplexity": round(math.exp(min(loss, 30.0)), 4),
        "accuracy": round(total_correct / total_tokens, 6),
        "tokens": int(total_tokens),
        "batches": n_batches,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        prog="python -m skypilot_tpu_torch.train.evaluate")
    ap.add_argument("--model", default="llama", choices=("llama", "moe"))
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from the latest checkpoint")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    from skypilot_tpu_torch import resolve_device
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.train import checkpoints, trainer

    device = resolve_device(args.device)
    model, default_cfg = ((moe, "moe-small") if args.model == "moe"
                          else (llama, "llama3-400m"))
    cfg = model.CONFIGS[args.config or default_cfg]
    args.seq = min(args.seq, cfg.max_seq_len)
    if args.ckpt_dir:
        with checkpoints.CheckpointManager(args.ckpt_dir) as mgr:
            params = mgr.restore(device=device)["params"]
            print(f"restored step {mgr.latest_step()}", file=sys.stderr)
    else:
        params = trainer.create_train_state(
            cfg, trainer.TrainConfig(), device, model=model)["params"]

    if args.packed:
        docs = ip.synthetic_doc_stream(
            args.batches * args.batch * 4, cfg.vocab_size,
            mean_len=args.seq // 3, seed=1)
        stream = ip.packed_batches(docs, args.batch, args.seq)
        batches = (ip.to_device(b, device)
                   for _, b in zip(range(args.batches), stream))
    else:
        batches = (trainer.synthetic_batch(cfg, args.batch, args.seq,
                                           seed=i, device=device)
                   for i in range(args.batches))

    out = evaluate(lambda p, b: model.loss_fn(p, b, cfg), params, batches)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
