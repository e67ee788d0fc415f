"""The benchmark's plain reference: what each cell's timed path must
produce, worked out again from the inputs the harness made.

Plain Python, hashlib and NumPy only. Nothing here imports ``jax``, the JAX
package or the port (``portbench/harness/isolation.py`` checks this, by
whole top-level module names), and nothing here takes a value the port
computed: the port's outputs are read only to be judged.

- ``goldilocks``, ``poseidon``, ``challenger``: the field, its quadratic
  extension, the Poseidon permutation and the Fiat-Shamir sponge (frozen
  copies of the published plonky2-style definitions the port follows);
- ``stark_verify``: a frozen host verifier for the skip and step proofs'
  STARKs (SkipAir, StepAir), with their constraints;
- ``tendermint``: protobuf encodings, header hashes, RFC 6962 trees and the
  Blobstream data commitment;
- ``ed25519``: RFC 8032 keys, signing and verification;
- ``consensus``: the public values a skip or step proof must carry, from the
  raw chain;
- ``ntt``: a plain Goldilocks NTT in NumPy.
"""
