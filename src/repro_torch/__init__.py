"""PyTorch/CUDA port of the DSD reproduction for one NVIDIA H100.

Mirrors the layout of the JAX reference package ``repro`` (which stays as
the reference the port is held against) and imports nothing of it. The
reference's Pallas TPU kernels become hand-written Hopper kernels under
``csrc/``; see ``kernels/__init__.py`` for their build and dispatch.
"""
