"""PyTorch/CUDA port of the diskless-checkpointing system in ``repro``.

The package mirrors ``src/repro/``'s module layout. It imports ``torch`` and
never ``jax`` or ``repro``: modules it needs from the JAX package are carried
over as copies. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; each hand-written CUDA kernel keeps a plain PyTorch twin
that runs for CPU tensors only.
"""
