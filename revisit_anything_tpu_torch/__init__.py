"""revisit_anything_tpu_torch — the PyTorch/CUDA port of revisit_anything_tpu.

It serves SegVLAD place-recognition queries (SAM automatic mask generation,
DINOv2 dense features, SuperSegment VLAD, PCA, kNN and weighted Borda) on
an NVIDIA H100. Module paths and function names mirror the JAX package,
which stays the reference; this package imports neither JAX nor it.

Every TPU kernel this serving path runs is a hand-written CUDA kernel for
sm_90a (``kernels/csrc``), built with nvcc at the first CUDA launch. A
kernel's wrapper runs its plain PyTorch version only for CPU tensors. The
TPU's single-kernel decode tail is ported too (``ops/decode_fused.py`` ->
``kernels/csrc/decode_tail.cu``), run by the three ``"fused_tail_*"``
decoder forms.
"""

__version__ = "0.1.0"
