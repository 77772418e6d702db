"""One rank of a multi-process run of visualbert_torch on the CPU (gloo),
for ``tests/test_torch_parallel.py``. It imports neither JAX nor
visualbert_tpu.

    python tests/torch_dist_worker.py SPEC RANK WORLD STORE OUT

SPEC is a ``torch.save``d dict: ``{"jobs": [(name, kwargs), ...]}``, the
jobs run in order on every rank; STORE a path for the ``file://``
rendezvous (no port); OUT a directory where each rank writes
``rank<r>.pt``, ``{job name: result}``. :func:`launch` starts the ranks
from a test and waits for them with a timeout.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def launch(jobs: List, world: int, tmp_path, env: Dict[str, str] = None, timeout: float = TIMEOUT_S) -> List[Dict]:
    """Run ``jobs`` on ``world`` ranks, each a process of its own; returns
    every rank's results. A rank that fails or outlives ``timeout`` fails
    the launch (every rank is killed). "{rank}" in an ``env`` value becomes
    the rank."""
    from visualbert_torch.parallel.distributed import run_ranks

    spec = os.path.join(tmp_path, "spec.pt")
    out = os.path.join(tmp_path, "out")
    os.makedirs(out, exist_ok=True)
    torch.save({"jobs": jobs}, spec)
    store = os.path.join(tmp_path, "store")
    base = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    envs = [dict(base, **{k: v.replace("{rank}", str(r)) for k, v in (env or {}).items()}) for r in range(world)]
    run_ranks([[sys.executable, os.path.abspath(__file__), spec, str(r), str(world), store, out] for r in range(world)],
              envs, timeout)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _rows(batch: Dict, index: int, size: int) -> Dict:
    """This data rank's contiguous rows of a global numpy batch."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_") or v is None:
            out[k] = v
            continue
        per = len(v) // size
        out[k] = v[index * per: (index + 1) * per]
    return out


def build_model(model_cfg: Dict, head_type: str, state=None, num_answers: int = 3129, kind: str = "task",
                kind_kw: Dict = None):
    """A model of the port: ``kind`` "task" (``VisualBertForTask``),
    "unsupervised" (``UnsupervisedVisualBert``, ``kind_kw`` its sizes) or
    "detector" (``VisualBertDetectorModel``, ``kind_kw`` its detector
    knobs; the detector's dropout off), loaded strict from ``state``."""
    from visualbert_torch.config import VisualBertConfig

    cfg = VisualBertConfig(**model_cfg)
    if kind == "unsupervised":
        from visualbert_torch.models.unsupervised import UnsupervisedConfig, UnsupervisedVisualBert

        model = UnsupervisedVisualBert(UnsupervisedConfig(bert=cfg, **kind_kw))
    elif kind == "detector":
        from visualbert_torch.models.vcr import VisualBertDetectorModel

        model = VisualBertDetectorModel(cfg, head_type, **kind_kw)
        model.detector.dropout_rate = 0.0
    else:
        from visualbert_torch.models.visualbert import VisualBertForTask

        model = VisualBertForTask(cfg, head_type, num_answers=num_answers)
    if state is not None:
        model.load_state_dict({k: v.clone() if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                               for k, v in state.items()}, strict=True)
    return model


class _Seeds:
    """Records the seeds the attention wrapper, the dropout-site wrapper and
    K9's wrapper receive (their plain versions run here)."""

    def __init__(self):
        from visualbert_torch.ops import dropout as dr
        from visualbert_torch.ops import flash_attention as fa
        from visualbert_torch.ops import layer_norm as ln

        self.attention, self.site, self.k9 = [], [], []
        self._mods = ((fa, "packed_attention_fwd"), (dr, "dropout_fwd"), (ln, "dropout_add_layer_norm_fwd"))
        self._orig = [getattr(mod, name) for mod, name in self._mods]
        attn, site, k9 = self._orig

        def attn_seeds(qkv, qb, key_bias, n_heads, rate, seed):
            self.attention.append(int(seed))
            return attn(qkv, qb, key_bias, n_heads, rate, seed)

        def site_seeds(x, rate, seed):
            self.site.append(int(seed))
            return site(x, rate, seed)

        def k9_seeds(x, res, scale, bias, rate, seed, eps=1e-12):
            self.k9.append(int(seed))
            return k9(x, res, scale, bias, rate, seed, eps)

        for (mod, name), fn in zip(self._mods, (attn_seeds, site_seeds, k9_seeds)):
            setattr(mod, name, fn)

    def close(self):
        for (mod, name), fn in zip(self._mods, self._orig):
            setattr(mod, name, fn)


def job_train(mesh, model_cfg, head_type, state, batches, opt, steps=None, num_answers=3129, record=False,
              local_state=False, kind="task", kind_kw=None, accum=1):
    """Train on the global ``batches`` (each rank on its data rows, in
    ``accum`` microbatches) from the full ``state``; returns every step's
    metrics, the gathered full parameters, with ``record`` the seeds and
    each step's gaps between this rank's whole-held gradients and its model
    rank 0's before the trainer's broadcast (``tools/mesh_path.py::
    watch_replica_grads``), and with ``local_state`` this rank's own
    (sharded) parameters."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig
    from visualbert_torch.parallel.mesh import gather_params
    from visualbert_torch.tools.mesh_path import watch_replica_grads
    from visualbert_torch.train.trainer import Trainer

    model = build_model(model_cfg, head_type, state, num_answers, kind, kind_kw)
    trainer = Trainer(model, OptimizerConfig(**opt), TrainConfig(seed=0, gradient_accumulation_steps=accum),
                      device="cpu", mesh=mesh).init_state(init_weights=state is None)
    seeds = _Seeds() if record else None
    gaps = watch_replica_grads(trainer) if record else None
    metrics = []
    try:
        for b in batches[:steps]:
            b = _rows(b, mesh.data_index, mesh.data_size)
            if accum > 1:  # as the fit loop stacks them: [accum, micro, ...]
                b = {k: v if k.startswith("_") else v.reshape((accum, -1) + v.shape[1:]) for k, v in b.items()}
            m = trainer.train_step(b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if seeds is not None:
            seeds.close()
    out = {"metrics": metrics, "params": {k: v.detach().clone() for k, v in
                                          gather_params(dict(model.named_parameters()), mesh).items()}}
    if record:
        out["seeds"] = {"attention": seeds.attention, "site": seeds.site, "k9": seeds.k9}
        out["grad_gaps"] = gaps
    if local_state:
        out["local"] = {k: v.detach().clone() for k, v in model.named_parameters()}
    out["index"] = (mesh.data_index, mesh.model_index)
    return out


def job_xent(mesh, x, emb, bias, labels, g):
    """``mlm_xent`` with ``mesh`` on this data rank's rows: nll, argmax and
    the gradients of ``(nll * g).sum()``."""
    from visualbert_torch.ops.mlm_xent import mlm_xent

    x, emb, bias = (torch.tensor(a, requires_grad=True) for a in (x, emb, bias))
    nll, am = mlm_xent(x, emb, bias, torch.tensor(labels), mesh=mesh)
    (nll * torch.tensor(g)).sum().backward()
    return {"nll": nll.detach(), "argmax": am, "dx": x.grad, "de": emb.grad, "db": bias.grad}


def job_unfused(mesh, model_cfg, state, batch):
    """The pretraining head under ``mesh`` on a batch whose MLM rows do not
    split over the model group: the loss, the gathered gradients, and
    whether the fused op ran."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig
    from visualbert_torch.models import heads
    from visualbert_torch.parallel.mesh import gather_params
    from visualbert_torch.train.trainer import Trainer, to_device

    model = build_model(model_cfg, "pretraining", state)
    trainer = Trainer(model, OptimizerConfig(), TrainConfig(), "cpu", mesh=mesh).init_state(init_weights=False)
    calls = []
    orig = heads.mlm_xent
    heads.mlm_xent = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        out = trainer.model(to_device(batch, "cpu"))
        out["loss"].backward()
    finally:
        heads.mlm_xent = orig
    grads = gather_params({k: p.grad for k, p in model.named_parameters()}, mesh)
    return {"loss": float(out["loss"]), "fused_calls": len(calls), "grads": grads}


def job_adam(mesh, params, grads, opt):
    """BertAdam over this rank's shards of ``params`` with the shards of
    ``grads`` each step; the gathered parameters."""
    from visualbert_torch.config import OptimizerConfig
    from visualbert_torch.parallel.mesh import gather_params, model_split_dim, shard_params
    from visualbert_torch.train.optimizer import BertAdam

    local = {k: torch.nn.Parameter(v) for k, v in shard_params(params, mesh).items()}
    split = {k for k in local if model_split_dim(k) is not None}
    adam = BertAdam(local.items(), OptimizerConfig(**opt), split=split, model_group=mesh.model_group)
    for g in grads:
        for k, v in shard_params(g, mesh).items():
            local[k].grad = v.clone()
        adam.step()
    return {"params": gather_params({k: p.detach() for k, p in local.items()}, mesh), "split": sorted(split)}


def job_checkpoint(mesh, model_cfg, state, folder, load=None):
    """Save a trainer built from ``state`` under ``mesh`` into ``folder``;
    with ``load``, first restore that checkpoint file. Returns the gathered
    parameters after the restore (or of ``state``)."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig
    from visualbert_torch.parallel.mesh import gather_params
    from visualbert_torch.train.trainer import Trainer
    from visualbert_torch.utils.checkpoint import CheckpointManager, load_trainer_state

    model = build_model(model_cfg, "pretraining", state)
    trainer = Trainer(model, OptimizerConfig(), TrainConfig(seed=0), "cpu", mesh=mesh).init_state(
        init_weights=False)
    if load is not None:
        load_trainer_state(trainer, load)
    path = CheckpointManager(folder).save(7, trainer)
    return {"path": path, "params": gather_params(dict(model.named_parameters()), mesh),
            "local_shapes": {k: tuple(p.shape) for k, p in model.named_parameters()}}


def job_gathered(mesh, model_cfg, state):
    """``Trainer.gathered()`` at ``mesh``: the parameters inside the block
    and their shapes after it and a second ``init_state``."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig
    from visualbert_torch.train.trainer import Trainer

    model = build_model(model_cfg, "pretraining", state)
    trainer = Trainer(model, OptimizerConfig(), TrainConfig(), "cpu", mesh=mesh).init_state(init_weights=False)
    with trainer.gathered():
        inside = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer.init_state(init_weights=False)  # a second init_state cuts the whole parameters again
    return {"inside": inside, "after": {k: tuple(p.shape) for k, p in model.named_parameters()},
            "adam": {k: tuple(p.shape) for k, p in trainer.optimizer.params.items()}}


def job_layout(mesh):
    """This rank's mesh shape and indices, its batch slice and shard."""
    from visualbert_torch.parallel.distributed import local_batch_slice, process_shard

    return {"shape": mesh.shape, "index": (mesh.data_index, mesh.model_index), "slice": local_batch_slice(8),
            "shard": mesh.batch_shard(), "process_shard": process_shard()}


def job_cli(mesh, argv):
    """``train_cli.main(argv)`` (the launch's environment brings
    torch.distributed up; every CLI job of a launch runs in that world);
    the epoch history."""
    from visualbert_torch import train_cli
    from visualbert_torch.parallel.mesh import gather_params

    trainer, result = train_cli.main(argv)
    return {"history": result.history, "step": trainer.step, "mesh": trainer.mesh.shape,
            "params": gather_params({k: p.detach() for k, p in trainer.model.named_parameters()}, trainer.mesh)}


JOBS = {"train": job_train, "xent": job_xent, "unfused": job_unfused, "adam": job_adam,
        "checkpoint": job_checkpoint, "gathered": job_gathered, "layout": job_layout, "cli": job_cli}


def main(spec, rank, world, store, out):
    torch.set_num_threads(1)
    from visualbert_torch.parallel import distributed
    from visualbert_torch.parallel.mesh import create_mesh

    jobs = torch.load(spec, weights_only=False)["jobs"]
    results = {}
    if jobs and jobs[0][1].get("job", jobs[0][0]) == "cli":
        # the CLI brings torch.distributed up itself, from the environment
        for name, kw in jobs:
            results[name] = job_cli(None, kw["argv"])
    else:
        distributed.initialize_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                                           timeout_s=120)
        meshes = {}
        for name, kw in jobs:
            kw = dict(kw)
            shape = tuple(kw.pop("mesh_shape"))
            if shape not in meshes:
                meshes[shape] = create_mesh(shape)
            results[name] = JOBS[kw.pop("job", name)](meshes[shape], **kw)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    distributed.barrier()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
