"""PyTorch/CUDA port of ``vidsgg_big_tpu`` for one NVIDIA H100.

The sub-packages mirror the JAX package (``ops``, ``data``, ``models``,
``train``, ``evaluation``, ``utils``, ``tools``) so each module's counterpart
is found by name.  The port imports ``torch`` and ``numpy`` and nothing of
JAX or of the JAX package; hand-written CUDA kernels live in ``csrc/`` and
are compiled with ``nvcc`` at first use (``ops/build.py``).
"""
