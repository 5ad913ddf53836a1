"""Cross-entropy losses (port of ray_tpu/ops/losses.py), in f32 and
max-shifted, without one-hot labels.

`blockwise_softmax_cross_entropy` never materializes the full
[tokens, vocab] logits: it walks sequence chunks, each chunk's unembed
matmul and log-softmax under `torch.utils.checkpoint`, and sums scalar
(nll, weight) pairs. Backward recomputes one chunk's logits at a time.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood in f32. The max is a constant for
    the gradient everywhere it appears, so the gradient is exactly
    softmax - onehot(label)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    label_logits = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - label_logits


def softmax_cross_entropy_with_int_labels(logits, labels, where=None):
    """Returns (mean_loss, total_weight)."""
    nll = _token_nll(logits, labels)
    if where is not None:
        w = where.float()
        total = torch.clamp(w.sum(), min=1.0)
        return (nll * w).sum() / total, total
    return nll.mean(), torch.tensor(float(nll.numel()), device=nll.device)


def _chunk_nll(x_c, unembed, l_c, w_c):
    nll = _token_nll(torch.einsum("bsd,dv->bsv", x_c, unembed), l_c)
    return (nll * w_c).sum()


def blockwise_softmax_cross_entropy(x, unembed, labels, where=None,
                                    chunk: int = 1024):
    """Memory-efficient CE over the unembed projection: x [batch, seq,
    d_model], unembed [d_model, vocab], labels [batch, seq]. Returns
    (mean_loss, total_weight), the same function as projecting the full
    logits and calling `softmax_cross_entropy_with_int_labels`. Chunks
    along the sequence axis; the padding of the last chunk has zero
    weight."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    w = (torch.ones((b, s), dtype=torch.float32, device=x.device)
         if where is None else where.float())
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    sum_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    sum_w = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        sum_nll = sum_nll + checkpoint(
            _chunk_nll, x[:, sl], unembed, labels[:, sl], w[:, sl],
            use_reentrant=False,
        )
        sum_w = sum_w + w[:, sl].sum()
    total = torch.clamp(sum_w, min=1.0)
    return sum_nll / total, total
