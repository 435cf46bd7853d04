"""MATE (n-ary join discovery) in PyTorch with hand-written CUDA kernels.

The port of ``repro`` (JAX) to PyTorch on an NVIDIA H100.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Entry points
(``core.session.MateSession.build``, ``core.index.MateIndex``,
``core.index.build_index``) run on the CUDA device unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.
"""
