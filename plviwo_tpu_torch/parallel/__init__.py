"""Distributed layer: rank groups over torch.distributed, sequence-sharded
replay, landmark-sharded Schur-complement BA (port of plviwo_tpu/parallel).

Importing a module of this package starts no process group and no process:
`replay.init_rank_group` and `replay.run_ranks` do."""
