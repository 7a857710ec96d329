"""Training entry point: ``python -m skypilot_tpu_torch.train.run``.

Counterpart of ``skypilot_tpu/train/run.py`` for dense Llama, the
sparse MoE decoder (``--model moe``, default config ``moe-small``) and
the pipelined llama (``--model pipeline``, default ``pp-tiny``).
Examples::

    # llama3-1b, full width and depth, on the card
    python -m skypilot_tpu_torch.train.run --config llama3-1b --steps 100

    # llama3-tiny over 2 CPU ranks at tp 2, one process per rank, from
    # the gang driver's env contract (the same variables the reference
    # reads)
    for r in 0 1; do JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 \
        JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$r \
        python -m skypilot_tpu_torch.train.run --device cpu \
        --config llama3-tiny --seq 32 --steps 3 --tp 2 & done; wait

    # moe-small (the reference's llm/moe-train.yaml line, without --ep)
    python -m skypilot_tpu_torch.train.run --model moe --config moe-small \
        --steps 500 --seq 2048

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
``mesh`` (the reference's dict of axis sizes).

The mesh, as the reference builds it: the process joins the
``torch.distributed`` rendezvous from the env contract first
(``parallel/distributed.py``: one process per card, or per CPU rank
with ``--device cpu``), the world's ranks are factored by
``default_shape_for(n, tp=, dp=, ...)`` (the rest on fsdp) and the
batch defaults to 4 x (dp x fsdp), rounded to that degree. The trainer
gets the mesh when its size is above 1; a size-1 mesh keeps the plain
one-card step (a deliberate difference: the one-card step stays as
fast as it was, and a one-rank mesh computes the same numbers).
Checkpoints are saved whole and restored onto any mesh.

Context and pipeline parallelism, as the reference's: ``--sp N`` splits
the sequence over an sp axis of the mesh (ring attention,
``parallel/ring_attention.py``), ``--zigzag`` adds the zigzag layout to
the activation rules (llama or moe; the identity on one rank), and
``--model pipeline`` (default config ``pp-tiny``) trains the
stage-stacked llama of ``parallel/pipeline.py``, with ``--pp N`` its
stages split over a pp axis; the batch is rounded to the microbatch
count. ``--packed`` with ``--model pipeline`` is refused, as the
reference refuses it. Not ported yet, refused with a message naming
what is to come: ``--ep`` above 1, and ``--model moe`` or ``--lora``
over more than one rank (the sharded MoE and LoRA steps). ``--qlora``
on more than one rank logs and trains on one, as the reference does.

Two CPU ranks pipelined, and two splitting packed sequences::

    for r in 0 1; do JAX_COORDINATOR_ADDRESS=127.0.0.1:29500 \\
        JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$r \\
        python -m skypilot_tpu_torch.train.run --device cpu \\
        --model pipeline --pp 2 --seq 32 --steps 3 & done; wait
    # ... --config llama3-tiny --sp 2 --zigzag --packed --seq 64

Fine-tuning, the reference's branches: ``--lora RANK`` trains rank-RANK
adapters over a frozen float base drawn from seed 1
(``train/lora.py``); ``--qlora RANK`` over a frozen int8 base
(``train/qlora.py``): with ``--qlora-random-base`` random int8 weights
drawn on the card (``kvcache.random_quantized_params``: the float tree
never exists), else a float init from seed 1, quantized layer by layer
and freed before the first step. The recipe ``llm/qlora-8b.yaml``::

    python -m skypilot_tpu_torch.train.run --config llama3-8b \
        --qlora 16 --qlora-random-base --xent-chunk 512 --seq 2048 \
        --batch 2

As in the reference, the adapter steps are not wrapped in the trainer's
compile watch or its ``skytpu_train_*`` instrumentation (the dense step
is); the goodput ledger books them as it books the dense step, and
``--resume`` restores the adapter state under ``restart_replay``.

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


def _persist(gp, mgr) -> None:
    """The goodput stamps beside the checkpoints, from rank 0 alone (the
    ranks' ledgers book the same steps)."""
    from skypilot_tpu_torch.parallel import distributed
    if distributed.rank() == 0:
        gp.persist(mgr.directory)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the loop; prints the summary line and also returns it, with
    the logged ``losses`` and ``step_ms`` (the wall time per step
    between logging syncs), the goodput ledger's ``train_step``
    ``records`` and its final ``snapshot`` added."""
    ap = argparse.ArgumentParser(prog="python -m skypilot_tpu_torch.train.run")
    ap.add_argument("--model", default="llama",
                    choices=("llama", "moe", "pipeline"))
    ap.add_argument("--config", default=None,
                    help="llama3-400m (llama), moe-small (moe) or pp-tiny "
                         "(pipeline) by default")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch (0 = 4 x data-parallel degree)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--xent-chunk", type=int, default=None,
                    help="chunked cross-entropy: the [B,S,vocab] logits "
                         "never exist at once (0 = unchunked)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--packed", action="store_true",
                    help="packed-sequence input (segment-masked "
                         "attention) over synthetic variable-length docs")
    ap.add_argument("--zigzag", action="store_true",
                    help="zigzag (load-balanced causal) ring attention "
                         "for sp>1; llama only")
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="LoRA finetune: train rank-RANK adapters over "
                         "frozen base weights (llama only)")
    ap.add_argument("--qlora", type=int, default=0, metavar="RANK",
                    help="QLoRA finetune: int8-quantized frozen base + "
                         "rank-RANK adapters (llama only, one card)")
    ap.add_argument("--qlora-random-base", action="store_true",
                    help="random int8 base drawn on the card (skips the "
                         "float init)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    # The reference's argument errors, in its order.
    if args.packed and args.model == "pipeline":
        ap.error("--packed is not supported with --model pipeline")
    if args.lora and args.model != "llama":
        ap.error("--lora currently supports --model llama only")
    if args.lora < 0:
        ap.error("--lora rank must be positive")
    if args.qlora:
        if args.model != "llama":
            ap.error("--qlora currently supports --model llama only")
        if args.lora:
            ap.error("--lora and --qlora are mutually exclusive")
        if args.qlora < 0:
            ap.error("--qlora rank must be positive")
    if args.zigzag and args.model not in ("llama", "moe"):
        # Only llama's and moe's forwards apply the zigzag permute.
        ap.error("--zigzag supports --model llama or moe only")
    if args.ep > 1:
        ap.error(f"--ep {args.ep} is not ported yet: expert parallelism "
                 f"(the sharded MoE step) is still to come")

    import skypilot_tpu_torch.callbacks as sky_callback
    from skypilot_tpu_torch.data import input_pipeline as ip
    from skypilot_tpu_torch.models import llama, moe
    from skypilot_tpu_torch.observability import attribution, flight
    from skypilot_tpu_torch.observability import goodput as goodput_lib
    from skypilot_tpu_torch.parallel import distributed
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline
    from skypilot_tpu_torch.parallel import sharding as sh_rules
    from skypilot_tpu_torch.train import checkpoints, trainer

    device = resolve_device(args.device)
    # Multi-process: join the cluster-wide rendezvous from the runtime's
    # env contract before touching the mesh.
    distributed.initialize_from_env(device)
    n = distributed.world_size()
    shape = mesh_lib.default_shape_for(n, tp=args.tp, sp=args.sp,
                                       dp=args.dp, ep=args.ep, pp=args.pp)
    if n > 1 and args.model == "moe":
        ap.error("--model moe over more than one rank is not ported yet: "
                 "the sharded MoE step (with --ep) is still to come")
    if n > 1 and args.lora:
        ap.error("--lora over more than one rank is not ported yet: the "
                 "sharded LoRA step is still to come")
    model, default_cfg = {"llama": (llama, "llama3-400m"),
                          "moe": (moe, "moe-small"),
                          "pipeline": (pipeline, "pp-tiny")}[args.model]
    args.config = args.config or default_cfg
    cfg = model.CONFIGS[args.config]
    if args.xent_chunk is not None:
        cfg = dataclasses.replace(cfg, xent_chunk=args.xent_chunk)
    args.seq = min(args.seq, cfg.max_seq_len)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"mesh: {shape.as_dict()} over {n} devices ({name})")
    data_degree = shape.dp * shape.fsdp
    batch = args.batch or 4 * data_degree
    if batch % data_degree:
        batch = data_degree * max(1, batch // data_degree)
    micro = getattr(cfg, "n_microbatches", None)
    if micro and batch % micro:
        batch = micro * max(1, batch // micro)
    if args.qlora and n > 1:
        # The int8 base is unsharded: each rank trains on its own card
        # rather than dying on a multi-card job. Sharded multi-card
        # fine-tuning is --lora (still to come).
        log(f"--qlora is single-chip: using 1 of {n} devices")
        n = 1
        batch = args.batch or 4
    mesh = mesh_lib.make_mesh(shape, device) if n > 1 else None
    shardings = (trainer.state_shardings(cfg, mesh, model=model)
                 if mesh is not None else None)
    act_rules = sh_rules.ACT_RULES
    if args.zigzag:
        act_rules = dict(act_rules, seq_layout="zigzag")
    log(f"device: {device} ({name}); {args.config} "
        f"{cfg.num_params():,} params, batch {batch} x seq {args.seq}")
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

    mgr = checkpoints.CheckpointManager(args.ckpt_dir) \
        if args.ckpt_dir else None
    resume = bool(mgr and args.resume and mgr.latest_step() is not None)

    def restore():
        gp.load_stamps(mgr.directory)
        with gp.account("restart_replay"):
            restored = mgr.restore(device=device, shardings=shardings)
        log(f"resumed from step {restored['step']}")
        return restored

    if args.qlora or args.lora:
        from skypilot_tpu_torch.train import lora
        lc = lora.LoRAConfig(rank=args.qlora or args.lora)
        n_lora = lora.num_trainable_params(cfg, lc)
        if args.qlora:
            from skypilot_tpu_torch.infer import kvcache
            from skypilot_tpu_torch.train import qlora
            if args.qlora_random_base:
                fp_params, qweights = kvcache.random_quantized_params(
                    cfg, device=device)
            else:
                base = llama.init_params(
                    cfg, torch.Generator(device=device).manual_seed(1), device)
                qweights = {"blocks": kvcache.quantize_block_weights(base),
                            "head": kvcache.quantize_head(base, cfg)}
                fp_params = kvcache.slim_params(base)
                del base    # the int8 copy replaces the float weights
            log(f"QLoRA rank {args.qlora}: {n_lora:,} trainable over an "
                f"int8 base of {cfg.num_params():,} params")
            state = (restore() if resume
                     else qlora.create_qlora_state(cfg, lc, tc, device))
            raw_step = qlora.make_qlora_train_step(cfg, lc, tc)
            step_fn = lambda s, b: raw_step(s, qweights, fp_params, b)
        else:
            base_params = llama.init_params(
                cfg, torch.Generator(device=device).manual_seed(1), device)
            log(f"LoRA rank {args.lora}: {n_lora:,} trainable / "
                f"{cfg.num_params():,} base params (frozen)")
            state = (restore() if resume
                     else lora.create_lora_state(cfg, lc, tc, device))
            raw_step = lora.make_lora_train_step(cfg, lc, tc)
            step_fn = lambda s, b: raw_step(s, base_params, b)
    else:
        step_fn = trainer.make_train_step(cfg, tc, watch=watch, model=model,
                                          mesh=mesh, act_rules=act_rules)
        if resume:
            state = restore()
        else:
            with gp.account("warmup_compile"):
                state = trainer.create_train_state(cfg, tc, device,
                                                   model=model, mesh=mesh)
    start_step = int(state["step"])

    batches = None
    batch_data = None
    if args.packed:
        def batch_stream():
            seed = 0
            while True:
                docs = ip.synthetic_doc_stream(
                    256, cfg.vocab_size, mean_len=args.seq // 3, seed=seed)
                yield from ip.packed_batches(docs, batch, args.seq)
                seed += 1

        batches = ip.prefetch(batch_stream(), device=device)
    else:
        batch_data = trainer.synthetic_batch(cfg, batch, args.seq,
                                             device=device)
    try:
        if start_step >= args.steps:
            log(f"checkpoint already at step {start_step}; nothing to "
                f"train")
            out = {"steps": 0, "resumed_step": start_step,
                   "mesh": shape.as_dict()}
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
                    _persist(gp, mgr)
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
            _persist(gp, mgr)
    finally:
        if batches is not None:
            batches.close()
        if mgr:
            mgr.close()
    snap = gp.snapshot()
    tokens_per_s = batch * args.seq * (args.steps - start_step) / wall
    out = {
        "final_loss": round(loss, 4),
        "steps": args.steps - start_step,
        "wall_s": round(wall, 2),
        "tokens_per_sec": round(tokens_per_s, 1),
        "tokens_per_sec_per_chip": round(tokens_per_s / n, 1),
        "goodput": round(snap["goodput_ratio"], 4),
        "mesh": shape.as_dict(),
    }
    print(json.dumps(out), flush=True)
    return dict(out, losses=losses, step_ms=step_ms, records=records,
                snapshot=snap)


if __name__ == "__main__":
    main()
