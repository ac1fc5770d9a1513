"""Fused linear + cross-entropy: the vocab projection without the logits
(mirrors ``accelerate_tpu/ops/fused_xent.py``).

For a causal LM the ``[tokens, vocab]`` f32 logits are the largest
activation (batch 10 x seq 2048 x vocab 32000 = 2.6 GB) and feed one
reduction.  The loss walks the vocab in chunks: the forward keeps only an
online logsumexp and the label logit per token; the backward rebuilds each
chunk's probabilities and contracts them at once into ``d_hidden`` and
``d_weight``.  The chunk products are plain large matrix products, as in
the JAX package (which leaves them to XLA): on the card each is one cuBLAS
GEMM with bf16 operands and f32 accumulation and output
(``torch.mm(..., out_dtype=torch.float32)``); on the CPU the operands are
widened to f32 first, which computes the same sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MASK = -0.7 * float(torch.finfo(torch.float32).max)


def _mm_f32(a, b):
    """``a @ b`` with f32 accumulation and an f32 result."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _pad_vocab(weight, num_chunks: int, vocab_major: bool):
    """Pad the vocab axis to ``num_chunks`` equal chunks (JAX
    ``_pad_vocab``); padded columns are masked by the ``cols < v`` guards."""
    v = weight.shape[0] if vocab_major else weight.shape[1]
    chunk = -(-v // num_chunks)
    pad = num_chunks * chunk - v
    if pad:
        weight = F.pad(weight, (0, 0, 0, pad) if vocab_major else (0, pad))
    return weight, v, chunk


def _chunk(weight_p, c: int, chunk: int, vocab_major: bool):
    """Chunk ``c`` of the weight as ``[H, chunk]`` (a view)."""
    if vocab_major:  # [V, H]
        return weight_p[c * chunk:(c + 1) * chunk].t()
    return weight_p[:, c * chunk:(c + 1) * chunk]


def _chunk_stats(hidden, weight, labels, num_chunks: int, vocab_major: bool):
    """The online logsumexp pass over ``weight``'s vocab chunks: each
    row's running max ``m``, its sum of ``exp(logit - m)`` ``l`` and its
    label's logit (0 where the label is not among ``weight``'s columns;
    ``labels`` index them)."""
    n = hidden.shape[0]
    weight_p, v, chunk = _pad_vocab(weight, num_chunks, vocab_major)
    dev = hidden.device
    m = torch.full((n,), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros(n, dtype=torch.float32, device=dev)
    label_logit = torch.zeros(n, dtype=torch.float32, device=dev)
    for c in range(num_chunks):
        logits = _mm_f32(hidden, _chunk(weight_p, c, chunk, vocab_major))
        cols = c * chunk + torch.arange(chunk, device=dev)
        logits = torch.where(cols < v, logits, _MASK)
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        idx = torch.clamp(labels - c * chunk, 0, chunk - 1)
        in_chunk = (labels >= c * chunk) & (labels < (c + 1) * chunk) & (labels < v)
        ll = torch.gather(logits, 1, idx[:, None].long())[:, 0]
        label_logit = torch.where(in_chunk, ll, label_logit)
        m = m_new
    return m, l, label_logit


def _chunk_grads(hidden, weight, labels, coef, lse, num_chunks: int, vocab_major: bool):
    """``(d_hidden, d_weight)`` of the loss: each chunk's ``softmax -
    onehot`` against ``lse``, weighted by ``coef`` ``[N, 1]``."""
    weight_p, v, chunk = _pad_vocab(weight, num_chunks, vocab_major)
    dev = hidden.device
    dh = torch.zeros(hidden.shape, dtype=torch.float32, device=dev)
    dw = torch.zeros(weight_p.shape, dtype=torch.float32, device=dev)
    rows = torch.arange(hidden.shape[0], device=dev)
    for c in range(num_chunks):
        w_c = _chunk(weight_p, c, chunk, vocab_major)            # [H, chunk]
        logits = _mm_f32(hidden, w_c)
        cols = c * chunk + torch.arange(chunk, device=dev)
        p = torch.where(cols < v, torch.exp(logits - lse[:, None]), 0.0)
        # p - onehot(labels): subtract 1 at each row's label column
        in_chunk = (labels >= c * chunk) & (labels < (c + 1) * chunk) & (labels < v)
        hit = rows[in_chunk]
        p[hit, (labels[in_chunk] - c * chunk).long()] -= 1.0
        dlogits = (p * coef).to(hidden.dtype)                    # [N, chunk]
        dh += _mm_f32(dlogits, w_c.t())
        if vocab_major:
            dw[c * chunk:(c + 1) * chunk] = _mm_f32(dlogits.t(), hidden)
        else:
            dw[:, c * chunk:(c + 1) * chunk] = _mm_f32(hidden.t(), dlogits)
    dw = dw[:v] if vocab_major else dw[:, :v]
    return dh.to(hidden.dtype), dw.to(weight.dtype)


class _FusedLinearXent(torch.autograd.Function):
    """JAX ``fused_linear_xent``'s custom_vjp: ``_fwd`` (:69) and ``_bwd``
    (:98), chunked over the vocab."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, mask, num_chunks, vocab_major):
        m, l, label_logit = _chunk_stats(hidden, weight, labels, num_chunks, vocab_major)
        lse = m + torch.log(torch.where(l == 0, 1.0, l))
        n_valid = torch.clamp(mask.float().sum(), min=1.0)
        loss = ((lse - label_logit) * mask).sum() / n_valid
        ctx.save_for_backward(hidden, weight, labels, mask, lse, n_valid)
        ctx.num_chunks, ctx.vocab_major = num_chunks, vocab_major
        return loss

    @staticmethod
    def backward(ctx, gbar):
        hidden, weight, labels, mask, lse, n_valid = ctx.saved_tensors
        coef = (mask.float() * (gbar / n_valid))[:, None]
        dh, dw = _chunk_grads(hidden, weight, labels, coef, lse, ctx.num_chunks,
                              ctx.vocab_major)
        return dh, dw, None, None, None, None


def fused_linear_xent(hidden, weight, labels, mask, num_chunks: int, vocab_major: bool):
    """Mean next-token CE over the ``mask``-ed rows of ``hidden`` ``[N,
    H]`` against ``weight`` ``[V, H]`` (``vocab_major``) or ``[H, V]``;
    ``labels`` ``[N]`` in ``[0, V)``.  Differentiable in hidden and weight."""
    return _FusedLinearXent.apply(hidden, weight, labels, mask, num_chunks, vocab_major)


def fused_causal_lm_loss(hidden, weight, labels, *, vocab_major: bool, num_chunks: int = 8,
                         ignore_index: int = -100, shifted: bool = False):
    """Shifted next-token CE from pre-head hidden states ``[B, T, H]``
    (JAX ``fused_causal_lm_loss``).  ``shifted=True``: labels are already
    next-token aligned."""
    if shifted:
        h = hidden.reshape(-1, hidden.shape[-1])
        lab = labels.reshape(-1)
    else:
        h = hidden[:, :-1].reshape(-1, hidden.shape[-1])
        lab = labels[:, 1:].reshape(-1)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, 0)
    return fused_linear_xent(h, weight, safe, mask, num_chunks, vocab_major)


# ---------------------------------------------------------------------------
# the vocab-parallel form (lm_head sharded over tp)
# ---------------------------------------------------------------------------


class _VocabParallelXent(torch.autograd.Function):
    """The fused CE over this rank's vocab shard ``weight`` ``[V/tp, H]``
    (rows ``offset ..``): each rank walks its shard's chunks; the running
    maxima, the sums of exponentials (rescaled to the common maximum) and
    the label's logit (from the rank whose shard holds it) are combined
    over ``tp``.  The backward is the shard's ``softmax - onehot`` against
    the combined lse; the hidden gradient it returns is this shard's part,
    summed over ``tp`` by the op that brought ``hidden`` in (``pbroadcast``
    or the sequence gather)."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, mask, num_chunks, offset, axis_name, mesh):
        from ..parallel import collectives as C

        local = labels - offset        # outside [0, V/tp): another rank's label
        m, l, label_logit = _chunk_stats(hidden, weight, local, num_chunks, True)
        m_all = C.pmax(m, axis_name, mesh)
        l_all = C.psum(l * torch.exp(m - m_all), axis_name, mesh)
        label_logit = C.psum(label_logit, axis_name, mesh)
        lse = m_all + torch.log(torch.where(l_all == 0, 1.0, l_all))
        n_valid = torch.clamp(mask.float().sum(), min=1.0)
        loss = ((lse - label_logit) * mask).sum() / n_valid
        ctx.save_for_backward(hidden, weight, local, mask, lse, n_valid)
        ctx.num_chunks = num_chunks
        return loss

    @staticmethod
    def backward(ctx, gbar):
        hidden, weight, local, mask, lse, n_valid = ctx.saved_tensors
        coef = (mask.float() * (gbar / n_valid))[:, None]
        dh, dw = _chunk_grads(hidden, weight, local, coef, lse, ctx.num_chunks, True)
        return dh, dw, None, None, None, None, None, None


def vocab_parallel_causal_lm_loss(hidden, weight, labels, *, offset: int, num_chunks: int = 8,
                                  ignore_index: int = -100, shifted: bool = False,
                                  axis_name: str = "tp", mesh=None):
    """:func:`fused_causal_lm_loss` with the head's vocab rows sharded over
    ``axis_name``: ``weight`` ``[V/tp, H]`` holds rows ``offset ..`` of
    the ``[V, H]`` head, ``labels`` are global ids.  Every rank returns the
    loss of the whole vocab; ``num_chunks`` chunks the shard."""
    if shifted:
        h = hidden.reshape(-1, hidden.shape[-1])
        lab = labels.reshape(-1)
    else:
        h = hidden[:, :-1].reshape(-1, hidden.shape[-1])
        lab = labels[:, 1:].reshape(-1)
    mask = lab != ignore_index
    safe = torch.where(mask, lab, 0)
    return _VocabParallelXent.apply(h.contiguous(), weight, safe, mask, max(1, num_chunks),
                                    int(offset), axis_name, mesh)
