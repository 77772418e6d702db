"""Typed configuration of the PyTorch port (counterpart of
``visualbert_tpu/config.py``): the same model fields and defaults, torch
dtypes.

The JAX config's TPU-only execution fields (:data:`TPU_ONLY_MODEL_FIELDS`,
:data:`TPU_ONLY_TRAIN_FIELDS`) change no math and have no counterpart here;
:meth:`VisualBertConfig.from_dict` and ``utils/config_io.py`` skip them in a
config file. A field that selects code the port does not have raises in
:meth:`VisualBertConfig.check_ported`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

TPU_ONLY_MODEL_FIELDS = ("remat", "scan_layers", "ffn_recompute_act", "ffn_save_dact", "mesh")
TPU_ONLY_TRAIN_FIELDS = ("steps_per_dispatch", "compiler_options")

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _dtype(x) -> torch.dtype:
    if isinstance(x, torch.dtype):
        return x
    return _DTYPES[str(x)]


@dataclasses.dataclass(frozen=True)
class VisualBertConfig:
    """Model hyper-parameters (reference ``BertConfig``,
    modeling.py:71-158, plus the visual stream, modeling.py:1169-1257)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    visual_embedding_dim: int = 2048
    bypass_transformer: bool = False
    output_attention_weights: bool = False

    # --- execution knobs ---
    dtype: Any = torch.bfloat16        # activation / compute dtype
    param_dtype: Any = torch.float32   # parameter dtype
    use_flash_attention: bool = False  # fused attention kernels: K1/K2 packed
    packed_qkv: bool = True             # False: K11/K12 heads-major
    use_fused_layer_norm: bool = False  # K7-K10 residual add + LayerNorm kernels
    flash_save_probs: bool = False      # packed with saved probabilities: K13/K14
    fused_mlm_xent: bool = False
    fast_dropout: bool = False         # dropout site kernels on K3's Philox body

    def __post_init__(self):
        object.__setattr__(self, "dtype", _dtype(self.dtype))
        object.__setattr__(self, "param_dtype", _dtype(self.param_dtype))

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        return self.hidden_size // self.num_attention_heads

    def replace(self, **kw) -> "VisualBertConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def base(cls, **kw) -> "VisualBertConfig":
        """bert-base-uncased geometry."""
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "VisualBertConfig":
        """bert-large geometry (the JAX package's ``large``)."""
        defaults = dict(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw) -> "VisualBertConfig":
        """A small config for CPU tests (the JAX package's ``tiny``)."""
        defaults = dict(
            vocab_size=512,
            hidden_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
            dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_dict(cls, d: dict) -> "VisualBertConfig":
        """From a config file's ``model`` block: the TPU-only fields are
        skipped, any other unknown key raises (as the JAX loader does)."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known - set(TPU_ONLY_MODEL_FIELDS)
        if unknown:
            raise KeyError(f"unknown VisualBertConfig keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in known})

    def check_ported(self) -> None:
        """Raise for options whose code is not ported: the port's FFN has the
        reference's exact-erf GELU only."""
        if self.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {self.hidden_act!r}: the port has the exact-erf gelu")


HEAD_TYPES = ("pretraining", "multichoice", "vqa", "vqa_advanced", "nlvr", "flickr")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """BertAdam settings (reference optimization.py:185-302,
    model_wrapper.py:100-139)."""

    learning_rate: float = 5e-5
    schedule: Optional[str] = "warmup_linear"  # none | warmup_constant | warmup_cosine | warmup_linear
    warmup: float = 0.1
    t_total: int = -1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    no_decay: Tuple[str, ...] = ("bias", "layer_norm", "LayerNorm")
    # parameter names containing any of these get no update (their moments
    # still move); None = task default, () = train everything
    frozen: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop settings (reference train.py:64-115), the JAX
    ``TrainConfig``'s defaults. Its TPU-only fields (``steps_per_dispatch``,
    ``compiler_options``) have no counterpart here. ``mesh_shape`` is the
    (data, model) mesh over the launch's ranks (``parallel/mesh.py``); its
    product must be the number of ranks, else every rank goes on the data
    axis."""

    train_batch_size: int = 32
    eval_batch_size: int = 32
    num_train_epochs: int = 10
    gradient_accumulation_steps: int = 1
    patience: int = 100000            # early stop patience (train.py:398-400)
    seed: int = 42
    save_every: Optional[int] = None  # mid-epoch checkpoint cadence, in batches
    log_every: int = 100
    num_workers: int = 8              # Batcher threads (0 = sequential)
    nan_guard: bool = False
    mesh_shape: Tuple[int, int] = (1, 1)  # (data, model) ranks

    def __post_init__(self):
        object.__setattr__(self, "mesh_shape", tuple(int(x) for x in self.mesh_shape))
