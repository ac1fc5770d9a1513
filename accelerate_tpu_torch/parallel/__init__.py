"""Parallelism over ``torch.distributed`` (mirrors
``accelerate_tpu/parallel/``): the mesh collectives, the FSDP and tp
sharding plan and the sharded step, ring attention, Ulysses attention,
the GPipe pipeline, MoE routing and the expert split, the hierarchical
multi-node gradient reduction and the PowerSGD codec, and the in-process
virtual world that runs a gang's ranks on one card."""

from . import collectives, expert_parallel, pipeline_parallel  # noqa: F401
