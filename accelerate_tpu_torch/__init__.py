"""PyTorch and CUDA port of ``accelerate_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one, mirroring its module paths.  It
imports ``torch``, ``numpy`` and the standard library only — never JAX nor
the JAX package.  Its first slice is the paged serving engine: the Llama
model with dense and paged KV caches, the page allocator, the
continuous-batching scheduler, the engine and the replay harness, with
hand-written CUDA kernels for paged decode and paged prefill attention
(``csrc/paged_attention.cu``).  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``.
"""

from .generation import GenerationConfig, generate, sample_logits
from .models import LlamaConfig, LlamaForCausalLM
from .serving import Request, ServingEngine, replay, synthesize_trace
from .utils.dataclasses import ServingPlugin

__all__ = [
    "GenerationConfig",
    "LlamaConfig",
    "LlamaForCausalLM",
    "Request",
    "ServingEngine",
    "ServingPlugin",
    "generate",
    "replay",
    "sample_logits",
    "synthesize_trace",
]
