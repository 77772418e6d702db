"""PyTorch port of visualbert_tpu, for NVIDIA Hopper GPUs.

The JAX package ``visualbert_tpu`` is the reference; this package mirrors
its layout (``config``, ``ops``, ``models``, ``train``, ``tools``) and
imports neither JAX nor ``visualbert_tpu``. Its hot ops run through CUDA
kernels written for ``sm_90a`` (``csrc/``), built at first use.
"""
