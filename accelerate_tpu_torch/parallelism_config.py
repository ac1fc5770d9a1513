"""N-D parallelism configuration -> :class:`torch.distributed.device_mesh.DeviceMesh`
(mirrors ``accelerate_tpu/parallelism_config.py``).

The sizes, the joint dimension names, the validation and its messages, the
environment transport and ``batch_spec`` are the JAX package's host logic
unchanged.  :meth:`ParallelismConfig.build_device_mesh` builds a
``DeviceMesh`` over the process group's ranks with every axis of
:data:`MESH_AXIS_ORDER` (size-1 axes included), in the JAX package's
canonical order; :meth:`ParallelismConfig.mesh_layout` returns that
layout, ``(names, shape)``, without building anything, so a plan can be
made for a world this process is not part of.

One process drives one card, so a "device" of the JAX mesh is a rank
here: rank ``r`` sits at the row-major position ``r`` of the mesh shape.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

# the JAX package's canonical axis order (outermost first): dcn, then the
# replicate and pipeline axes, then the axes that shard within a replica
MESH_AXIS_ORDER = ("dcn", "dp_replicate", "pp", "dp_shard", "cp", "sp", "tp", "ep")

AXIS_SIZE_FIELDS = tuple(f"{name}_size" for name in MESH_AXIS_ORDER)


class PartitionSpec(tuple):
    """The JAX ``PartitionSpec``: one entry per dimension, each ``None``, a
    mesh axis name or a tuple of names (a joint axis)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


@dataclass
class ParallelismConfig:
    """Validated sizes for each parallelism axis (JAX ``ParallelismConfig``):
    the product of all sizes must equal the world's rank count; any axis can
    stay at 1; ``dp_shard_size=-1`` infers the remainder."""

    dcn_size: int = 1
    dp_replicate_size: int = 1
    dp_shard_size: int = 1
    cp_size: int = 1
    sp_size: int = 1
    tp_size: int = 1
    ep_size: int = 1
    pp_size: int = 1

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        """Rebuild from the ``PARALLELISM_CONFIG_*`` variables, the
        launcher's transport."""
        return cls(**{
            field: int(os.environ.get(f"PARALLELISM_CONFIG_{field.upper()}", "1"))
            for field in AXIS_SIZE_FIELDS
        })

    def to_env(self) -> dict[str, str]:
        return {
            f"PARALLELISM_CONFIG_{field.upper()}": str(getattr(self, field))
            for field in AXIS_SIZE_FIELDS
        }

    # -- sizes -------------------------------------------------------------

    def _sizes(self) -> dict[str, int]:
        return {
            "dcn": self.dcn_size,
            "dp_replicate": self.dp_replicate_size,
            "dp_shard": self.dp_shard_size,
            "cp": self.cp_size,
            "sp": self.sp_size,
            "tp": self.tp_size,
            "ep": self.ep_size,
            "pp": self.pp_size,
        }

    @property
    def total_size(self) -> int:
        total = 1
        for v in self._sizes().values():
            total *= v
        return total

    @property
    def non_data_parallel_size(self) -> int:
        """cp * sp * tp * ep * pp: the ranks of one data-parallel group,
        which all read the same batches."""
        return self.cp_size * self.sp_size * self.tp_size * self.ep_size * self.pp_size

    @property
    def data_parallel_size(self) -> int:
        return self.dcn_size * self.dp_replicate_size * self.dp_shard_size

    @property
    def has_dcn(self) -> bool:
        return self.dcn_size > 1

    # -- joint dimension names -----------------------------------------------

    @property
    def dp_dim_names(self) -> tuple[str, ...]:
        return self._enabled(("dcn", "dp_replicate", "dp_shard"))

    @property
    def dp_shard_cp_dim_names(self) -> tuple[str, ...]:
        """The FSDP sharding axes under cp."""
        return self._enabled(("dp_shard", "cp"))

    @property
    def dp_cp_dim_names(self) -> tuple[str, ...]:
        """The axes the loss averages over."""
        return self._enabled(("dcn", "dp_replicate", "dp_shard", "cp"))

    @property
    def fsdp_dim_names(self) -> tuple[str, ...]:
        """The axes parameters shard over under FULL / HYBRID shard."""
        return self.dp_shard_cp_dim_names

    @property
    def batch_dim_names(self) -> tuple[str, ...]:
        """The axes the batch dimension of input data shards over."""
        return self._enabled(("dcn", "dp_replicate", "dp_shard"))

    @property
    def seq_dim_names(self) -> tuple[str, ...]:
        """The axes the sequence dimension shards over (the cp ring)."""
        return self._enabled(("cp", "sp"))

    def _enabled(self, names: Sequence[str]) -> tuple[str, ...]:
        sizes = self._sizes()
        return tuple(n for n in names if sizes[n] > 1)

    @property
    def active_mesh_dims(self) -> tuple[str, ...]:
        return self._enabled(MESH_AXIS_ORDER)

    # -- validation and the mesh ---------------------------------------------

    def _validate(self, num_devices: int) -> None:
        sizes = self._sizes()
        for name, v in sizes.items():
            if name == "dp_shard" and v == -1:
                continue
            if v < 1:
                raise ValueError(f"{name}_size must be >= 1, got {v}")
        if self.cp_size > 1 and self.sp_size > 1:
            raise ValueError("cp_size and sp_size cannot both be > 1 (pick ring CP or Ulysses SP)")
        if self.dp_shard_size == -1:
            rest = (
                self.dcn_size * self.dp_replicate_size * self.cp_size * self.sp_size
                * self.tp_size * self.ep_size * self.pp_size
            )
            if num_devices % rest != 0:
                raise ValueError(
                    f"cannot infer dp_shard_size: {num_devices} devices not divisible by {rest}"
                )
            self.dp_shard_size = num_devices // rest
        if self.total_size != num_devices:
            raise ValueError(
                f"ParallelismConfig total size {self.total_size} "
                f"({self._sizes()}) != available devices {num_devices}"
            )

    def mesh_layout(self, num_devices: Optional[int] = None) -> tuple[tuple, tuple]:
        """``(names, shape)`` of the mesh over ``num_devices`` ranks (the
        process group's size by default), validated, with all eight axes
        in the canonical order; nothing is built."""
        if num_devices is None:
            from .state import world

            num_devices = world()[0]
        self._validate(num_devices)
        sizes = self._sizes()
        return MESH_AXIS_ORDER, tuple(sizes[name] for name in MESH_AXIS_ORDER)

    def build_device_mesh(self, device_type: Optional[str] = None):
        """The ``DeviceMesh`` over every rank of the process group, with the
        eight axes of :meth:`mesh_layout` (size-1 axes cost nothing, so a
        spec may name any axis).  ``device_type`` defaults to ``"cuda"``
        when the group's backend is NCCL, else ``"cpu"``."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError(
                "build_device_mesh needs a process group: construct an Accelerator (or "
                "PartialState) first, or call torch.distributed.init_process_group")
        names, shape = self.mesh_layout(dist.get_world_size())
        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device_type, shape, mesh_dim_names=names)

    # -- convenience specs -----------------------------------------------------

    def batch_spec(self, seq_axis: Optional[int] = 1, ndim: int = 2) -> PartitionSpec:
        """The spec of an input batch: batch dim over the dp axes, sequence
        dim over cp / sp."""
        entries: list = [self.batch_dim_names or None]
        for dim in range(1, ndim):
            if seq_axis is not None and dim == seq_axis and self.seq_dim_names:
                entries.append(self.seq_dim_names)
            else:
                entries.append(None)
        return PartitionSpec(*entries)

    def __str__(self):
        sizes = self._sizes()
        active = {k: v for k, v in sizes.items() if v > 1}
        return f"ParallelismConfig({active or 'single-device'})"

