"""Checkpoint layout names (the port's own copy of the checkpoint-layout
part of ``accelerate_tpu/utils/constants.py``, lines 15-33, under the same
names), so a checkpoint directory, its manifest and a ``save_model``
directory are laid out as the JAX package lays them out.
"""

from __future__ import annotations

# -- checkpoint layout (save_state/load_state, save_model) -------------------
MODEL_NAME = "model"
TRAIN_STATE_DIR = "train_state"
RNG_STATE_NAME = "random_states_{}.pkl"
CUSTOM_STATES_NAME = "custom_checkpoint_{}.pkl"
SAMPLER_STATES_NAME = "sampler_states.json"
SCHEDULER_STATES_NAME = "scheduler_states.json"
METADATA_NAME = "accelerate_metadata.json"
CHECKPOINT_DIR_PREFIX = "checkpoint"
CHECKPOINT_DIR_PATTERN = r"checkpoint_\d+"
# verified atomic checkpoints (checkpointing.py): every file stages under
# <dir>.tmp, the manifest (per-file sizes + crc32) is written last, and one
# os.replace publishes the directory — the pattern above intentionally does
# NOT match *.tmp, so scans/GC never see a half-written checkpoint
CHECKPOINT_TMP_SUFFIX = ".tmp"
CHECKPOINT_MANIFEST_NAME = "checkpoint_manifest.json"

# -- unified weights files (save_model) --------------------------------------
SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
SAFE_WEIGHTS_SHARD_PATTERN = "model-{:05d}-of-{:05d}.safetensors"

# -- the RNG streams a checkpoint captures: the JAX package's names, with
# "cuda" (every CUDA generator, torch.cuda.get_rng_state_all) for the port
RNG_TYPES = ["python", "numpy", "jax", "torch", "generator", "cuda"]
