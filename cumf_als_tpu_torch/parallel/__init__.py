"""Sharded training on torch.distributed (the JAX package's parallel/):
plans (plan.py), the communication layer (mesh.py) and ShardedALS
(sharded_als.py)."""
