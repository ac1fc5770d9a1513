"""BERT encoder for sequence classification, the model of ``nlp_example``
(mirrors ``accelerate_tpu/models/bert.py``).

The JAX module's arithmetic: f32 parameters cast to the compute dtype at
each dense, embedding and norm; layer norms take their statistics in f32;
exact GELU; attention is the port's plain ``native_attention`` (an f32
softmax; the padding mask as segment ids, pad tokens a segment of their
own), which the JAX package runs in XLA, not in a Pallas kernel; the
pooler and the classifier in f32.  Module names follow the flax ones
(``layers.{i}`` for ``layer_{i}``), so ``models/convert.py`` carries a
flax tree across by name.

The token-type table is HF's: ``forward(token_type_ids=None)`` adds no
type, which is type 0 once ``load_hf_bert`` has folded type 0 into the
position table (as the JAX loader does).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .llama import _apply, native_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def base(cls, **kw):
        """bert-base: hidden 768, 12 layers, 12 heads."""
        return cls(**kw)


class _Dense(nn.Linear):
    """``nn.Linear`` with f32 parameters run in ``dtype`` (flax ``Dense(dtype=,
    param_dtype=float32)``): the parameters are cast to it whatever width
    the train step's policy hands them in."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__(d_in, d_out, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _LayerNorm(nn.LayerNorm):
    """Statistics and affine in f32, the result in ``dtype``."""

    def __init__(self, hidden: int, eps: float, dtype: torch.dtype):
        super().__init__(hidden, eps=eps, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.compute_dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = _Dense(h, h, cfg.dtype)
        self.key = _Dense(h, h, cfg.dtype)
        self.value = _Dense(h, h, cfg.dtype)
        self.dense = _Dense(h, h, cfg.dtype)

    def forward(self, x, attention_mask=None):
        cfg = self.cfg
        b, t, _ = x.shape
        shape = (b, t, cfg.num_attention_heads, cfg.head_dim)
        q = self.query(x).reshape(shape)
        k = self.key(x).reshape(shape)
        v = self.value(x).reshape(shape)
        segment_ids = attention_mask.to(torch.int32) if attention_mask is not None else None
        out = native_attention(q, k, v, causal=False, segment_ids=segment_ids)
        return self.dense(out.reshape(b, t, cfg.hidden_size))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attention_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)
        self.output_norm = _LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype)

    def forward(self, x, attention_mask=None):
        x = self.attention_norm(x + self.attention(x, attention_mask))
        h = self.output(F.gelu(self.intermediate(x), approximate="none"))
        return self.output_norm(x + h)


class BertForSequenceClassification(nn.Module):
    """``forward(input_ids, attention_mask=None, token_type_ids=None) ->
    logits [B, num_labels]`` (f32).  Built on ``device`` (``"cuda"`` unless
    the caller asks for the CPU) with random weights from ``seed``."""

    def __init__(self, config: BertConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        dev = resolve_device(device)
        with torch.device(dev):
            h = cfg.hidden_size
            self.word_embeddings = nn.Embedding(cfg.vocab_size, h, dtype=torch.float32)
            self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h,
                                                    dtype=torch.float32)
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                      dtype=torch.float32)
            self.embeddings_norm = _LayerNorm(h, cfg.layer_norm_eps, cfg.dtype)
            self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_hidden_layers))
            self.pooler = _Dense(h, h, torch.float32)
            self.classifier = _Dense(h, cfg.num_labels, torch.float32)
        if self.device.type != "meta":       # big_modeling.init_empty_weights: no init
            self._init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Matrices ~ N(0, 0.02) (BERT's initializer range), biases and the
        token-type table zeros, norm scales ones."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias") or name.startswith("token_type"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=self.device) * 0.02)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        cfg = self.config
        b, t = input_ids.shape
        dt = cfg.dtype
        x = self.word_embeddings(input_ids).to(dt)
        pos = torch.arange(t, device=input_ids.device).expand(b, t)
        x = x + self.position_embeddings(pos).to(dt)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids).to(dt)
        x = self.embeddings_norm(x)
        for layer in self.layers:
            x = layer(x, attention_mask)
        pooled = torch.tanh(self.pooler(x[:, 0].float()))
        return self.classifier(pooled)


def make_bert_loss_fn(model: BertForSequenceClassification):
    """``loss_fn(params, batch)`` for ``Accelerator.prepare_train_step``:
    the mean cross-entropy of ``batch["labels"]`` (f32 log-softmax);
    ``batch`` holds ``input_ids`` and optionally ``attention_mask`` /
    ``token_type_ids``."""

    def loss_fn(params, batch):
        logits = _apply(model, params, batch["input_ids"],
                        attention_mask=batch.get("attention_mask"),
                        token_type_ids=batch.get("token_type_ids"))
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, batch["labels"].long()[:, None]).mean()

    return loss_fn
