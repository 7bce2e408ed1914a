"""Data parallelism: device meshes, the sharded step, multi-process runs.

Counterpart of the reference's ``parallel/`` package.  The batch axis
shards over every device of a :class:`~.mesh.Mesh`; registers stay
replicated and merge after each step (add for counts and the CMS files,
max for HLL), in one process over copies between devices and across
processes over ``torch.distributed`` collectives.
"""
