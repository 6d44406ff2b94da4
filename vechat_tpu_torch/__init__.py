"""vechat_tpu_torch — haplotype-aware long-read error correction on PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `vechat_tpu` (the JAX/Pallas package beside it, which stays the
reference). It imports torch and numpy, never jax and never `vechat_tpu`.

Layers (outside-in):
  cli/       vechat- and racon-compatible command line surfaces
  pipeline/  two-round correction driver, windowing, overlapper
  ops/       POA variation-graph engine + alignment DP (host oracles)
  ops/kernels/  torch wrappers of the CUDA kernels in csrc/*.cu, their
             plain PyTorch versions, and the batch aligner backend
  io/        FASTA/FASTQ/PAF readers and writers
  utils/     logging, timers
"""

__version__ = "0.1.0"
