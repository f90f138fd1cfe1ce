"""The parallel layer on ``torch.distributed`` (counterpart of
``uav_bs_ctrl_tpu/parallel/``): ``dist`` (process groups, collectives,
cross-rank statistics), ``mesh`` (device meshes, the sharded learner),
``graph_parallel`` (the edge-partitioned GATv2 and TarMAC attention),
``launch`` (ranks spawned on one machine) and ``workers`` (what they run).
Import the submodules; this package imports nothing, so that
``algos/buffer.py`` can use ``parallel.dist`` while ``parallel.mesh`` uses
``algos/buffer.py``."""
