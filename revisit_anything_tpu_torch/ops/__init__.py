"""Tensor ops of the serving slice; the five kernels' wrappers live in
``attention``, ``maskhead`` and ``maskresize``."""
