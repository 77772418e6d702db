"""The main path on a (data, model) mesh of ranks that share one CUDA card:
``tools/main_path.py``'s COCO pretraining step at bert-base, each rank a
process of its own over gloo (NCCL refuses two ranks on one device). It
checks the mesh's code paths on one card; it measures no scaling.

:func:`launch` starts the ranks from a caller (``chip_smoke.py`` phase 25)
and waits for them; each rank runs

    python -m visualbert_torch.tools.mesh_path SPEC RANK WORLD STORE OUT

SPEC is a ``torch.save``d dict: ``block`` (the model block), ``mesh``,
``steps``, ``gather`` (rank 0 writes the gathered full parameters) and
``replicas`` (every rank writes the parameters it holds whole, and how far
its whole-held gradients were from model rank 0's before the trainer's
broadcast, :func:`watch_replica_grads`). Each rank writes
``OUT/rank<r>.pt``: its losses, step times, peak memory, the kernels'
launches over its steps, its collectives' time and bytes a step
(:class:`Collectives`) and K1/K2's time on its heads.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

# the kernels of the path and their wrappers (module, function)
PATH_KERNELS = (
    ("K1", "flash_attention", "packed_attention_fwd"), ("K2", "flash_attention", "packed_attention_bwd"),
    ("K4", "mlm_xent", "mlm_xent_fwd"), ("K5", "mlm_xent", "mlm_xent_dx"), ("K6", "mlm_xent", "mlm_xent_de"),
    ("K7", "layer_norm", "add_layer_norm_fwd"), ("K8", "layer_norm", "add_layer_norm_bwd"),
    ("K9", "layer_norm", "dropout_add_layer_norm_fwd"), ("K10", "layer_norm", "dropout_add_layer_norm_bwd"),
    ("K3 site fwd", "dropout", "dropout_fwd"), ("K3 site bwd", "dropout", "dropout_bwd"),
)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _wrappers():
    import importlib

    return [(label, getattr(importlib.import_module(f"visualbert_torch.ops.{mod}"), fn))
            for label, mod, fn in PATH_KERNELS]


class Collectives:
    """Time (host clock) and bytes of every ``all_reduce`` and ``broadcast``
    the port makes within the block, by kind. ``sync`` (the card's
    ``torch.cuda.synchronize``) runs before and after each call, so a call's
    time is its own copies and host algorithm and not the compute queued
    before it; that serializes the step, which the instrument's cost is."""

    KINDS = ("all_reduce", "broadcast")

    def __init__(self, sync=lambda: None):
        self.sync = sync
        self.ms = dict.fromkeys(self.KINDS, 0.0)
        self.bytes = dict.fromkeys(self.KINDS, 0)
        self.calls = dict.fromkeys(self.KINDS, 0)

    def _timed(self, kind, fn):
        def call(tensor, *args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kwargs)
            self.sync()
            self.ms[kind] += (time.perf_counter() - t0) * 1e3
            self.bytes[kind] += tensor.numel() * tensor.element_size()
            self.calls[kind] += 1
            return out
        return call

    def __enter__(self):
        self._orig = {k: getattr(dist, k) for k in self.KINDS}
        for k in self.KINDS:
            setattr(dist, k, self._timed(k, self._orig[k]))
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(dist, k, fn)

    def per_step(self, steps: int) -> dict:
        return {k: dict(ms=self.ms[k] / steps, bytes=self.bytes[k] / steps, calls=self.calls[k] / steps)
                for k in self.KINDS}


def watch_replica_grads(trainer) -> list:
    """Before each step's reduction, how far this rank's gradient of every
    parameter its model group holds whole is from model rank 0's:
    max |g - g_0| / max |g_0| a tensor (max |g| where g_0 is 0), one dict a
    step, appended to the list returned. Model peers that drew different
    hidden-state dropout masks compute different whole-held gradients;
    the trainer's broadcast would hide that in the parameters. The
    comparison's own broadcast is not one of :class:`Collectives`'. Without
    model peers the list stays empty."""
    from visualbert_torch.parallel.mesh import model_split_dim

    mesh, reduce, gaps = trainer.mesh, trainer._reduce_grads, []
    if mesh is None or mesh.model_group is None:  # no model peers: nothing is broadcast
        return gaps

    def probed():
        whole = [(k, p) for k, p in trainer.model.named_parameters() if model_split_dim(k) is None]
        mine = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                          for _, p in whole])
        root = mine.clone()
        distributed_c10d.broadcast(root, src=mesh.model_root, group=mesh.model_group)
        step, off = {}, 0
        for k, p in whole:
            a, b = mine[off: off + p.numel()], root[off: off + p.numel()]
            off += p.numel()
            scale = float(b.abs().max())
            step[k] = float((a - b).abs().max()) / scale if scale > 0 else float(a.abs().max())
        gaps.append(step)
        reduce()

    trainer._reduce_grads = probed
    return gaps


def launch(spec: dict, world: int, tmp: str, timeout: float = 600) -> list:
    """Run ``spec`` on ``world`` ranks sharing card 0; every rank's result.
    A rank that fails or outlives ``timeout`` fails the launch, and every
    rank is stopped."""
    from visualbert_torch.parallel.distributed import run_ranks

    os.makedirs(tmp, exist_ok=True)
    path, out, store = os.path.join(tmp, "spec.pt"), os.path.join(tmp, "out"), os.path.join(tmp, "store")
    os.makedirs(out, exist_ok=True)
    torch.save(spec, path)
    env = dict(os.environ, LOCAL_RANK="0", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run_ranks([[sys.executable, "-m", "visualbert_torch.tools.mesh_path", path, str(r), str(world), store, out]
               for r in range(world)], [env] * world, timeout, cwd=REPO)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _attention_ms(mesh, batch_rows: int, iters: int = 10):
    """K1's and K2's time (CUDA events, through their wrappers) on this
    rank's heads: [rows, 228, H/m * 3 * 64] bf16, padded keys."""
    from visualbert_torch.ops.flash_attention import packed_attention_bwd, packed_attention_fwd
    from visualbert_torch.tools.main_path import TT, TV, cuda_ms

    H, D, T = 12 // mesh.model_size, 64, TT + TV
    g = torch.Generator(device="cuda").manual_seed(mesh.model_index)
    qkv = torch.randn(batch_rows, T, 3 * H * D, device="cuda", generator=g).to(torch.bfloat16)
    qb = torch.zeros(3 * H * D, device="cuda", dtype=torch.bfloat16)
    key_bias = torch.zeros(batch_rows, T, device="cuda")
    key_bias[::3, TT - 20: TT] = -10000.0
    dout = torch.randn(batch_rows, T, H * D, device="cuda", generator=g).to(torch.bfloat16)
    out, stats = packed_attention_fwd(qkv, qb, key_bias, H, 0.1, 7)
    fwd = cuda_ms(lambda: packed_attention_fwd(qkv, qb, key_bias, H, 0.1, 7), iters)
    bwd = cuda_ms(lambda: packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, 0.1, 7), iters)
    return H, fwd, bwd


def run_rank(spec: dict, rank: int, world: int, store: str, out: str) -> None:
    from visualbert_torch.parallel import distributed
    from visualbert_torch.parallel.mesh import create_mesh, gather_params, model_split_dim
    from visualbert_torch.tools.main_path import build

    distributed.initialize_distributed("cuda", backend="gloo", init_method=f"file://{store}", rank=rank,
                                       world_size=world, timeout_s=600)
    mesh = create_mesh(spec["mesh"])
    trainer, batch = build(spec["block"], device="cuda", mesh=mesh)
    wrappers = _wrappers()
    grad_gaps = watch_replica_grads(trainer) if spec.get("replicas") else None
    for _, w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with Collectives(torch.cuda.synchronize) as collectives:
        for _ in range(spec["steps"]):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch)["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launches = {label: w.launches for label, w in wrappers}
    result = dict(mesh=mesh.shape, index=(mesh.data_index, mesh.model_index), losses=losses, step_ms=times,
                  median_ms=statistics.median(times), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  launches=launches, rows=len(batch["input_ids"]), collectives=collectives.per_step(spec["steps"]))
    if grad_gaps is not None:
        result["grad_gaps"] = grad_gaps
    params = dict(trainer.model.named_parameters())
    if spec.get("gather"):
        full = gather_params({k: p.detach() for k, p in params.items()}, mesh)
        if rank == 0:
            result["params"] = {k: v.float().cpu() for k, v in full.items()}
    if spec.get("replicas"):
        result["replicas"] = {k: p.detach().cpu() for k, p in params.items() if model_split_dim(k) is None}
    del trainer, params, batch
    torch.cuda.empty_cache()
    for r in range(world):  # one rank at a time on the shared card
        if r == rank:
            result["attention"] = _attention_ms(mesh, result["rows"])
        distributed.barrier()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    distributed.barrier()


if __name__ == "__main__":
    torch.set_num_threads(4)
    run_rank(torch.load(sys.argv[1], weights_only=False), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
