"""Kernels of the port: a plain PyTorch version (``ref.py``), a public
op (``ops.py``) and, where the JAX package has a Pallas kernel on the
main path, a hand-written CUDA kernel for Hopper (``kernel.py`` wrapping
``csrc/*.cu``, built by :mod:`._build`).

A kernel wrapper runs the plain version for tensors on the CPU and the
CUDA kernel for tensors on a CUDA device — there is no fallback from one
to the other — and counts its launches in ``wrapper.launches``.
"""
