"""PyTorch + CUDA port of the ``repro`` package, one slice at a time.

Imports ``torch`` and never ``jax`` or ``repro``.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
