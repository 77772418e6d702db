"""Training CLI of the port (counterpart of ``visualbert_tpu/train_cli.py``;
the reference's ``python train.py -config C -folder F``, train.py:64-87):

    python -m visualbert_torch.train_cli --config configs/coco_pretrain.json \\
        [--folder runs/x] [--task coco_pretrain] [--restore runs/x/ckpt] \\
        [--eval_only] [--device cuda|cpu]

It runs on the CUDA card (the kernels) unless ``--device cpu`` asks for the
CPU (their plain versions); without a card and without ``--device cpu`` it
exits with an error. ``--eval_only`` restores ``--restore``, evaluates the
task's eval split and writes its prediction file. It prints one JSON line
at the end: {"task", "best_metric", "best_epoch", "epochs_run"}.

On several GPUs, one process each:

    torchrun --nproc_per_node N -m visualbert_torch.train_cli --config C --folder F

with ``"train": {"mesh_shape": [d, m]}`` (d * m = N; data-parallel d,
tensor-parallel m; ``train_batch_size`` stays the global batch).
``torch.distributed`` comes up first, from torchrun's RANK / WORLD_SIZE /
LOCAL_RANK / MASTER_ADDR (NCCL on CUDA, gloo with ``--device cpu``), and a
launch that fails to come up raises. Rank 0 prints the JSON line.
"""

from __future__ import annotations

import argparse
import json
import math


def main(argv=None):
    p = argparse.ArgumentParser(description="visualbert_torch trainer")
    p.add_argument("--config", required=True, help="comment-tolerant JSON config")
    p.add_argument("--folder", default=None, help="output folder override")
    p.add_argument("--task", default=None, help="task override")
    p.add_argument("--restore", default=None, help="checkpoint directory or file to restore")
    p.add_argument("--eval_only", action="store_true", help="skip training, eval + dump predictions")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"train_cli: --device {args.device} but no CUDA device is available; "
                         "pass --device cpu to run the kernels' plain versions on the CPU")

    from visualbert_torch.parallel import distributed

    distributed.initialize_distributed(torch.device(args.device).type)

    from visualbert_torch.tasks import registry
    from visualbert_torch.utils.config_io import load_task_config

    cfg = load_task_config(
        args.config,
        overrides={
            "folder": args.folder,
            "task": args.task,
            "restore_checkpoint": args.restore,
            "eval_only": True if args.eval_only else None,
        },
    )
    trainer, result = registry.run(cfg, args.device)
    best = result.best_metric
    if distributed.rank() != 0:
        return trainer, result
    print(json.dumps({
        "task": cfg.task,
        # strict JSON: tasks without an eval split track no best metric
        "best_metric": best if math.isfinite(best) else None,
        "best_epoch": result.best_epoch,
        "epochs_run": result.epochs_run,
    }), flush=True)
    return trainer, result


if __name__ == "__main__":
    main()
