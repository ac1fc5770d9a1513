"""The Accelerator: train state and train step on one device (mirrors the
single-device, non-offload path of ``accelerate_tpu/accelerator.py``).

The training loop keeps the JAX package's shape::

    acc = Accelerator(mixed_precision="bf16",
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    state = acc.create_train_state(model, "lion-sr")
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4))
    for batch in batches:
        state, metrics = step(state, batch)     # grads, clip, update

The state's params are a name -> tensor dict in the order the JAX package
flattens its param tree (the stochastic-rounding salts key on it).  Given a
module, they are its own parameter tensors, so the module trains in place.
PyTorch runs eagerly: where the JAX step is one jitted program that
donates its input state, the port's step updates the params **in
place**, which saves holding a second copy of the weights.

Off this path, and raising ``NotImplementedError`` with their ROADMAP
item: FSDP/TP/parallelism configs and PowerSGD / hierarchical gradient
compression (A13), cpu offload (A12), fp16 loss scaling and fp8 (A12), the
NaN guard and the donation audits (A14), accumulation carried across calls
(A7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Any, Callable, Optional, Union

import torch
from torch import nn

from .ops.precision import Policy, get_policy
from .ops.stochastic_rounding import GradientTransformation, flax_leaf_order
from .optimizer import AcceleratedOptimizer, make_optimizer
from .state import AcceleratorState, GradientState
from .utils.dataclasses import GradientAccumulationPlugin, GradSyncKwargs
from .utils.random import get_rng_key


@dataclasses.dataclass
class TrainState:
    """The train state the framework owns (JAX ``TrainState``)."""

    step: int
    params: dict
    opt_state: Any
    rng: torch.Generator
    apply_fn: Optional[Callable] = None
    tx: Optional[GradientTransformation] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum ||t||^2)`` over a list or dict of tensors, accumulated in
    f32 (one reduction per tensor, no f32 copy of a bf16 one)."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    if not tensors:
        return torch.tensor(0.0)
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.sqrt(torch.stack(norms).square().sum())


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


class Accelerator:
    """One device (``"cuda"`` unless ``cpu=True`` or ``device=`` says
    otherwise), mixed precision ``"no"`` or ``"bf16"``, gradient
    accumulation, and the train step."""

    def __init__(self, mixed_precision: Optional[str] = None, gradient_accumulation_steps: int = 1,
                 cpu: bool = False, device=None, parallelism_config=None, fsdp_plugin=None,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 resilience_plugin=None, kwargs_handlers: Optional[list] = None):
        if parallelism_config is not None:
            raise _not_ported("parallelism_config (FSDP/TP/CP over several GPUs)", "A13")
        if fsdp_plugin is not None:
            raise _not_ported("fsdp_plugin (sharding and cpu offload)", "A12/A13")
        if resilience_plugin is not None:
            raise _not_ported("resilience_plugin (NaN guard, preemption, snapshots)", "A14")
        self.grad_sync_kwargs = GradSyncKwargs()
        for handler in kwargs_handlers or []:
            if not isinstance(handler, GradSyncKwargs):
                raise _not_ported(f"kwargs handler {type(handler).__name__}", "A14")
            self.grad_sync_kwargs = handler
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        elif (gradient_accumulation_steps != 1
              and gradient_accumulation_plugin.num_steps != gradient_accumulation_steps):
            raise ValueError(
                "Pass gradient_accumulation_steps OR gradient_accumulation_plugin, not "
                "conflicting both"
            )
        if gradient_accumulation_plugin.mode != "in_step":
            raise _not_ported("gradient accumulation mode 'across_steps' (the carried "
                              "accumulator of the python loop)", "A7")
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu, device=device)
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self.policy: Policy = get_policy(self.state.mixed_precision)
        self.step_count = 0
        self._in_accumulate = False

    # -- introspection ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    # -- optimizer and train state ---------------------------------------

    def prepare_optimizer(self, optimizer: Union[str, GradientTransformation,
                                                 AcceleratedOptimizer]) -> AcceleratedOptimizer:
        """A recipe name (:func:`~.optimizer.make_optimizer`), a
        transformation, or an :class:`AcceleratedOptimizer`."""
        if isinstance(optimizer, AcceleratedOptimizer):
            return optimizer
        if isinstance(optimizer, str):
            optimizer = make_optimizer(optimizer)
        return AcceleratedOptimizer(optimizer)

    def create_train_state(self, params: Union[nn.Module, dict], optimizer,
                           apply_fn: Optional[Callable] = None,
                           rng: Optional[torch.Generator] = None) -> TrainState:
        """The train state over ``params`` (a module — its own parameter
        tensors — or a name -> tensor dict), ordered as the JAX package
        flattens its tree, with the optimizer state initialised on them."""
        if isinstance(params, nn.Module):
            params = {n: p.detach() for n, p in params.named_parameters()}
        params = {n: params[n] for n in flax_leaf_order(params)}
        dev = self.device
        for name, p in params.items():
            if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
                raise ValueError(f"param {name} is on {p.device}, the accelerator on "
                                 f"{self.device}")
        tx = self.prepare_optimizer(optimizer).tx
        return TrainState(
            step=0,
            params=params,
            opt_state=tx.init(list(params.values())),
            rng=rng if rng is not None else get_rng_key(0, device=self.device),
            apply_fn=apply_fn,
            tx=tx,
        )

    # -- the train step --------------------------------------------------

    def prepare_train_step(self, loss_fn: Callable,
                           max_grad_norm: Optional[float] = None) -> Callable:
        """``step(state, batch) -> (new_state, metrics)`` for
        ``loss_fn(params, batch [, rng])``: gradients (f32, or bf16 with
        ``GradSyncKwargs(grad_dtype="bf16")``), in-step accumulation over
        ``gradient_accumulation_steps`` microbatches (summed in f32),
        global-norm clipping in each gradient's own width, the optimizer
        update in place.  ``metrics`` holds ``loss`` and ``grad_norm`` as
        device tensors (no host sync)."""
        gsk = self.grad_sync_kwargs
        if gsk.compression or gsk.dcn_compression or gsk.hierarchical:
            raise _not_ported("gradient compression / hierarchical reduction", "A13")
        if gsk.grad_dtype not in (None, "bf16"):
            raise ValueError(f"GradSyncKwargs.grad_dtype supports only 'bf16', got "
                             f"{gsk.grad_dtype!r}")
        comm_dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, None: None}[gsk.comm_dtype]
        wants_rng = "rng" in inspect.signature(loss_fn).parameters
        accum_steps = self.gradient_state.num_steps
        policy = self.policy
        compute_width = gsk.grad_dtype is not None

        def compute_grads(params: dict, batch, rng):
            names = list(params)
            if compute_width:
                # differentiate with respect to the compute-width copy: every
                # gradient is born bf16
                leaves = [p.detach().to(policy.compute_dtype).requires_grad_()
                          for p in params.values()]
                p_in = dict(zip(names, leaves))
            else:
                leaves = [p.detach().requires_grad_() for p in params.values()]
                p_in = policy.cast_to_compute(dict(zip(names, leaves)))
            loss = (loss_fn(p_in, batch, rng) if wants_rng else loss_fn(p_in, batch)).float()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
            if comm_dtype is not None:
                grads = [g.to(comm_dtype) for g in grads]
            if not compute_width:
                grads = [g.float() for g in grads]
            return loss.detach(), grads

        def apply_update(state: TrainState, grads: list, loss):
            gnorm = global_norm(grads)
            if max_grad_norm is not None:
                clip = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                # in each grad's own width: an f32 scalar would promote a
                # bf16 tree back to f32
                grads = [g * clip.to(g.dtype) for g in grads]
            params = state.params
            leaves = list(params.values())
            new_leaves, new_opt = state.tx.update(grads, state.opt_state, leaves)
            with torch.no_grad():
                for p, new in zip(leaves, new_leaves):
                    p.copy_(new)
            return (state.replace(step=state.step + 1, params=params, opt_state=new_opt),
                    {"loss": loss, "grad_norm": gnorm})

        def microbatches(batch):
            def piece(x, i):
                if not torch.is_tensor(x) or x.dim() == 0:
                    return x
                if x.shape[0] % accum_steps:
                    raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                     f"gradient_accumulation_steps {accum_steps}")
                n = x.shape[0] // accum_steps
                return x[i * n:(i + 1) * n]
            return [{k: piece(v, i) for k, v in batch.items()} for i in range(accum_steps)]

        def step_fn(state: TrainState, batch):
            if accum_steps == 1:
                loss, grads = compute_grads(state.params, batch, state.rng)
                return apply_update(state, grads, loss)
            acc, loss_sum = None, torch.zeros((), device=self.device)
            for mb in microbatches(batch):
                loss, grads = compute_grads(state.params, mb, state.rng)
                # the sum runs in f32 whatever the gradients' width
                if acc is None:
                    acc = [g.float() for g in grads]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g.float())
                loss_sum = loss_sum + loss
            return apply_update(state, [a / accum_steps for a in acc], loss_sum / accum_steps)

        def wrapped(state: TrainState, batch):
            if not self._in_accumulate:
                self.step_count += 1
            return step_fn(state, batch)

        return wrapped

    # -- the reference's loop surface -----------------------------------

    def backward(self, loss=None, **kwargs):
        raise RuntimeError(
            "The prepared train step computes the gradients: define "
            "`loss_fn(params, batch)` and use `accelerator.prepare_train_step(loss_fn)`; the "
            "returned step runs the gradients, accumulation, clipping and the optimizer update."
        )

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Accumulation bookkeeping (JAX ``accumulate``): with the ``in_step``
        mode every batch syncs, so this only counts the step; a step run
        inside the context leaves the count to it."""
        self.step_count += 1
        self.gradient_state._set_sync_gradients(True)
        self._in_accumulate = True
        try:
            yield
        finally:
            self._in_accumulate = False

    def clip_grad_norm_(self, grads, max_norm: float, norm_type: float = 2.0):
        """Global-norm clip of a list or dict of gradients; returns
        ``(clipped, norm)``.  Inside a prepared step pass ``max_grad_norm``."""
        if norm_type != 2.0:
            raise NotImplementedError("only L2 global-norm clipping is supported")
        gnorm = global_norm(grads)
        clip = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
        if isinstance(grads, dict):
            return {k: g * clip for k, g in grads.items()}, gnorm
        return [g * clip for g in grads], gnorm
