"""SPMD over torch.distributed: the sharded NTT, Merkle trees and MSM, one
process (rank) per shard (mesh.py); the multi-process bring-up
(distributed.py)."""
