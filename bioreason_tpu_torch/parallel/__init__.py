"""Multi-device execution on torch.distributed (the port of
bioreason_tpu/parallel/): the mesh, the partition rules and their
execution, sequence parallelism for both DNA towers, GPipe."""
