"""PyTorch/CUDA port of the QAC system for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (the reference it is held
against) and imports nothing of it: ``core/`` holds the index structures
and engines, ``kernels/<name>/`` the hand-written CUDA kernels' wrappers
(``ops.py``) beside their plain PyTorch versions (``ref.py``), ``serve/``
the class-routed frontend, ``text/`` the synthetic log generator, and
``csrc/`` the CUDA sources.
"""
