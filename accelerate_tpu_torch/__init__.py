"""PyTorch and CUDA port of ``accelerate_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one, mirroring its module paths.  It
imports ``torch``, ``numpy`` and the standard library only — never JAX nor
the JAX package.  Its first slice is the paged serving engine: the Llama
model with dense and paged KV caches, the page allocator, the
continuous-batching scheduler, the engine and the replay harness, with
hand-written CUDA kernels for paged decode and paged prefill attention
(``csrc/paged_attention.cu``).  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``.

Its second slice is the single-device bf16 training step: ``Accelerator``
(``create_train_state``, ``prepare_train_step``), the optimizer recipes
with the stochastic-rounding bf16 optimizers, the chunked fused linear +
cross-entropy loss, and hand-written CUDA flash-attention kernels for the
forward, dq and dk/dv (``csrc/flash_attention.cu``).
"""

from .accelerator import Accelerator, TrainState
from .generation import GenerationConfig, generate, sample_logits
from .models import LlamaConfig, LlamaForCausalLM, make_llama_loss_fn
from .optimizer import AcceleratedOptimizer, make_optimizer
from .serving import Request, ServingEngine, replay, synthesize_trace
from .utils.dataclasses import GradientAccumulationPlugin, GradSyncKwargs, ServingPlugin

__all__ = [
    "AcceleratedOptimizer",
    "Accelerator",
    "GenerationConfig",
    "GradSyncKwargs",
    "GradientAccumulationPlugin",
    "LlamaConfig",
    "LlamaForCausalLM",
    "Request",
    "ServingEngine",
    "ServingPlugin",
    "TrainState",
    "generate",
    "make_llama_loss_fn",
    "make_optimizer",
    "replay",
    "sample_logits",
    "synthesize_trace",
]
