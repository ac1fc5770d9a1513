"""Data and context parallelism over ``torch.distributed`` (mirrors
``accelerate_tpu/parallel/``): the mesh collectives, the FSDP sharding
plan and ring attention."""
