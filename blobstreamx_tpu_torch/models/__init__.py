"""Workload facades, the user-facing API of the port (the JAX package's
names):

- ``models.skip``         skip proofs (trusted header -> target header)
- ``models.step``         single-step header transitions
- ``models.sha256_stark`` batched SHA-256 STARKs and the data-commitment tree
"""
