"""Sharded training on torch.distributed (the JAX package's parallel/):
plans (plan.py), the communication layer (mesh.py), ShardedALS
(sharded_als.py) and ShardedOutOfCoreALS (sharded_ooc.py)."""
