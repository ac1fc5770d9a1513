"""PyTorch and CUDA port of ``accelerate_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one, mirroring its module paths.  It
imports ``torch``, ``numpy`` and the standard library only — never JAX nor
the JAX package.  Its first slice is the paged serving engine: the Llama
model with dense and paged KV caches, the page allocator, the
continuous-batching scheduler, the engine and the replay harness, with
hand-written CUDA kernels for paged decode and paged prefill attention
(``csrc/paged_decode.cu``, ``csrc/paged_prefill.cu``).  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``.

Its second slice is the single-device bf16 training step: ``Accelerator``
(``create_train_state``, ``prepare_train_step``), the optimizer recipes
with the stochastic-rounding bf16 optimizers, the chunked fused linear +
cross-entropy loss, and hand-written CUDA flash-attention kernels for the
forward, dq and dk/dv (``csrc/flash_attention.cu``).

Its third slice is quantized serving: int8 weight-only models (W8A16,
``utils/quantization.py``, ``quantize_model_``) through hand-written
W8A16 matmul kernels (``csrc/quantized_matmul.cu``), and int8 / fp8 KV
pages through the paged kernels' quantized variants, both through
``ServingEngine`` and ``generate_paged``.

Its fourth slice is multi-tenant LoRA serving: ``ops/lora.py``
(``lora_apply`` and the gather-matmul kernel #10, ``csrc/lora.cu``), the
adapter pool ``serving/adapters.py`` (``AdapterStore``: hot-swap from
pinned host memory on a side stream, LRU, refcount pinning), per-slot
adapter routing through ``ServingEngine`` and ``generate_paged``, and the
fused LoRA-query + paged-decode op ``fused_bgmv_paged_decode`` (kernels
#8 / #9, on the decode kernels' split page loop in ``csrc/paged_decode.cu``).

Its thirteenth slice is the resumable training loop: ``prepare`` of a
``torch.utils.data.DataLoader`` (``data_loader.py``), schedules
(``scheduler.py``), verified atomic checkpoints (``checkpointing.py``:
``save_state`` sync and async, ``load_state``, ``maybe_resume``,
``save_model``) on the native IO engine (``native/``) and safetensors
(``utils/serialization.py``), the NaN guard, preemption and goodput
(``resilience/``).

Its fourteenth slice is big-model inference: a checkpoint from disk onto
the card even when it does not fit (``big_modeling.py``: meta-device init,
placement across the card, pinned host memory and disk, streaming loads,
``load_checkpoint_and_serve``; ``models.load_hf_llama``;
``load_and_quantize_model``), the module hooks that run offloaded weights
(``hooks.py``), fp8 weight storage (``layerwise_casting``), and the
layer-streamed decode and beam search (``generate_streamed``,
``beam_search``).
Its fifteenth slice is the memory and precision recipes of training:
activation recomputation and the scanned layer stack with boundaries
offloaded to the host (``LlamaConfig.remat`` / ``scan_layers``), the
int8-state ``-sr8`` optimizers (``ops/int8_state.py``), fp16 loss scaling
with f16 instances of the flash kernels, fp8 matmuls with delayed scaling
(``ops/fp8.py``, ``torch._scaled_mm`` on the card), and the ZeRO-offload
host update (``FullyShardedDataParallelPlugin(cpu_offload=True)``).
Its sixteenth slice is multi-tenant LoRA fine-tuning
(``serving.LoraTrainer``: one batched step over a mixed-tenant batch, each
tenant's weights and int8 optimizer state parked in host memory) and the
``Accelerator``'s one-card surface: the eval step, ``has_aux`` steps,
triggers, trackers (``tracking.py``), the profiler (``utils/profiler.py``
on ``torch.profiler``), the training timeline (``telemetry/timeline.py``),
``utils/memory.py``, and the examples' BERT and ResNet (``models/``).
Its seventeenth slice is data and context parallelism over
``torch.distributed``: the world of processes (``state.py``), the mesh
collectives (``parallel/collectives.py``) and the process collectives
(``ops/operations.py``), ``ParallelismConfig`` -> ``DeviceMesh``, the FSDP
sharding plan and the sharded train step (``parallel/sharding.py``,
``parallel/fsdp.py``), zigzag ring attention through the flash kernels
(``parallel/context_parallel.py``) and ``LocalSGD``.
Its eighteenth slice is tensor and sequence parallelism: the Llama's
Megatron column / row split on each rank's weight slices with the
vocab-parallel embedding and fused CE (``models/llama.py``,
``models/layers.py``, ``ops/fused_xent.py``), the ring collective matmul
(``ops/collective_matmul.py``), Ulysses attention with its
collective-matmul boundary (``parallel/sequence_parallel.py``), the
differentiable collectives and the in-process virtual world the card runs
them in (``parallel/collectives.py``, ``parallel/virtual.py``).
Its nineteenth slice is pipeline and expert parallelism: the GPipe
schedule over a ``pp`` axis (``parallel/pipeline_parallel.py``:
``prepare_pipeline``, ``PipelinedModel``), capacity top-k routing, the
dense dispatch and the ep split (``parallel/expert_parallel.py``), the
Mixtral MoE family with its HF loader (``models/mixtral.py``,
``models.load_hf_mixtral``) and ``utils/other.py``.
Its twentieth slice is multi-node data parallelism and the recovery
ladder: the hierarchical gradient reduction over a ``dcn`` axis with the
PowerSGD codec (``parallel/hierarchical.py``, ``parallel/powersgd.py``,
``GradSyncKwargs``), buddy-rank host-RAM snapshots
(``resilience/peer_ckpt.py``), ``Accelerator.recover``, the rank-loss
and straggler faults, a preemption stop agreed across ranks and
checkpoints of a replicated state across several processes.
Its twenty-first slice is the two-process serving fabric
(``test_utils/scripts/fleet_fabric.py``) and checkpoints of a train state
sharded or split across ranks, saved by each rank and restored onto any
plan (``checkpointing.py``).
"""

from . import hooks
from .accelerator import Accelerator, TrainState
from .big_modeling import (
    abstract_init,
    compute_module_sizes,
    cpu_offload,
    disk_offload,
    dispatch_model,
    get_max_memory,
    infer_auto_device_map,
    infer_auto_placement,
    init_empty_weights,
    init_on_device,
    init_params_leafwise,
    load_checkpoint_and_dispatch,
    load_checkpoint_and_serve,
    load_checkpoint_in_model,
    offload_state_dict,
    offload_store_params,
    offloaded_apply,
    serve_model,
)
from .checkpointing import CheckpointCorruptError
from .data_loader import prepare_data_loader, skip_first_batches
from .scheduler import AcceleratedScheduler
from .generation import (
    GenerationConfig,
    beam_search,
    generate,
    generate_paged,
    generate_streamed,
    place_params_host,
    sample_logits,
)
from .local_sgd import LocalSGD
from .parallelism_config import ParallelismConfig
from .hooks import (
    AlignDevicesHook,
    CpuOffloadHook,
    LayerwiseCastingHook,
    ModelHook,
    SequentialHook,
    add_hook_to_module,
    attach_align_device_hook,
    remove_hook_from_module,
)
from .models import (
    LlamaConfig,
    LlamaForCausalLM,
    MixtralConfig,
    MixtralForCausalLM,
    load_hf_llama,
    load_hf_mixtral,
    make_llama_loss_fn,
    make_mixtral_loss_fn,
)
from .parallel.pipeline_parallel import PipelinedModel, prepare_pipeline
from .ops.precision import layerwise_casting
from .ops.streaming import LayerPrefetcher, StreamStats
from .ops.quantized_matmul import quantized_matmul
from .optimizer import AcceleratedOptimizer, make_optimizer
from .ops.flash_attention import fused_bgmv_paged_decode
from .ops.lora import lora_apply
from .serving import AdapterStore, Request, ServingEngine, replay, synthesize_trace
from .utils.dataclasses import (
    ContextParallelConfig,
    DataLoaderConfiguration,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradSyncKwargs,
    LoraPlugin,
    ProjectConfiguration,
    ResiliencePlugin,
    SequenceParallelConfig,
    ServingPlugin,
    TensorParallelConfig,
)
from .utils.memory import find_executable_batch_size
from .utils.quantization import (
    QuantizationConfig,
    QuantizedTensor,
    dequantize,
    load_and_quantize_model,
    quantize,
    quantize_model_,
    quantize_params,
    quantized_apply,
)

__all__ = [
    "AcceleratedOptimizer",
    "AcceleratedScheduler",
    "Accelerator",
    "AdapterStore",
    "AlignDevicesHook",
    "CheckpointCorruptError",
    "ContextParallelConfig",
    "CpuOffloadHook",
    "DataLoaderConfiguration",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GenerationConfig",
    "GradSyncKwargs",
    "GradientAccumulationPlugin",
    "LayerPrefetcher",
    "LayerwiseCastingHook",
    "LocalSGD",
    "LlamaConfig",
    "LlamaForCausalLM",
    "LoraPlugin",
    "MixtralConfig",
    "MixtralForCausalLM",
    "ModelHook",
    "ParallelismConfig",
    "PipelinedModel",
    "ProjectConfiguration",
    "QuantizationConfig",
    "QuantizedTensor",
    "Request",
    "ResiliencePlugin",
    "SequenceParallelConfig",
    "SequentialHook",
    "ServingEngine",
    "ServingPlugin",
    "StreamStats",
    "TensorParallelConfig",
    "TrainState",
    "abstract_init",
    "add_hook_to_module",
    "attach_align_device_hook",
    "beam_search",
    "compute_module_sizes",
    "cpu_offload",
    "dequantize",
    "disk_offload",
    "dispatch_model",
    "find_executable_batch_size",
    "fused_bgmv_paged_decode",
    "generate",
    "generate_paged",
    "generate_streamed",
    "get_max_memory",
    "hooks",
    "infer_auto_device_map",
    "infer_auto_placement",
    "init_empty_weights",
    "init_on_device",
    "init_params_leafwise",
    "layerwise_casting",
    "load_and_quantize_model",
    "load_checkpoint_and_dispatch",
    "load_checkpoint_and_serve",
    "load_checkpoint_in_model",
    "load_hf_llama",
    "load_hf_mixtral",
    "lora_apply",
    "make_llama_loss_fn",
    "make_mixtral_loss_fn",
    "make_optimizer",
    "offload_state_dict",
    "offload_store_params",
    "offloaded_apply",
    "place_params_host",
    "prepare_data_loader",
    "prepare_pipeline",
    "quantize",
    "quantize_model_",
    "quantize_params",
    "quantized_apply",
    "quantized_matmul",
    "remove_hook_from_module",
    "replay",
    "sample_logits",
    "serve_model",
    "skip_first_batches",
    "synthesize_trace",
]
