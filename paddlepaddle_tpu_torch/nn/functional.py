"""Functional subset the Llama and MoE serving and training paths need
(counterpart of ``paddlepaddle_tpu/nn/functional.py``: ``swiglu`` :137,
``softmax`` / ``log_softmax`` :144-159, ``linear`` :183, ``embedding`` :202,
``rms_norm`` :336, the losses :920-1083 (``cross_entropy``,
``softmax_with_cross_entropy``, ``mse_loss``, ``l1_loss``,
``smooth_l1_loss``, ``nll_loss``, ``binary_cross_entropy``,
``binary_cross_entropy_with_logits``, ``kl_div``, ``cosine_similarity``,
``cosine_embedding_loss``, ``margin_ranking_loss``,
``hinge_embedding_loss``, ``triplet_margin_loss``),
``scaled_dot_product_attention`` :1193, ``flash_attention`` :1206,
``flash_attn_unpadded`` :1215). Plain tensor functions; weights keep the
paddle layout ``W: [in, out]``; attention keeps the ``[b, s, h, d]``
layout, varlen attention the packed ``[t, h, d]``.

Each function whose reference op carries a name passes its tensor inputs
through :func:`..amp.amp_cast` under that name (``linear``, ``embedding``,
``rms_norm``, ``softmax``, ``log_softmax``, ``cross_entropy``); the losses
the reference computes in an unnamed op pass ``None``, as the reference's
hook sees them (so its black-list entries ``mse_loss``, ``nll_loss`` & co.
never match there, nor here)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _tF

from ..amp import amp_cast
from ..core.dtype import to_torch_dtype


def linear(x: torch.Tensor, weight, bias: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """``y = x @ W (+ b)`` with ``W: [in, out]`` (reference :183). A weight
    that carries ``wo_matmul`` (an ``nn.quant.QuantizedWeight``) lowers
    through it, int8 codes with the scale applied after the product, and
    the result is cast back to ``x.dtype``. ``name`` is accepted for API
    parity."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    wo = getattr(weight, "wo_matmul", None)
    out = torch.matmul(x, weight) if wo is None else wo(x).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None,
              sparse: bool = False, name=None) -> torch.Tensor:
    """Row gather ``weight[x]`` (reference :202). Positions whose id is
    ``padding_idx`` (negative counts from the end) read zeros, so that row
    gets no gradient from them. ``sparse`` and ``name`` are accepted, and,
    as in the reference, not read."""
    (weight,) = amp_cast("embedding", weight)
    out = weight[x]
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else weight.shape[0] + padding_idx
        out = out.masked_fill((x == pad)[..., None], 0.0)
    return out


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None,
           name=None) -> torch.Tensor:
    """``silu(x) * y``; with ``y`` None, ``x``'s last axis is split in two
    halves, ``silu(first) * second`` (reference :137-141)."""
    if y is None:
        (x,) = amp_cast(None, x)
        half = x.shape[-1] // 2
        return _tF.silu(x[..., :half]) * x[..., half:]
    x, y = amp_cast(None, x, y)
    return _tF.silu(x) * y


def softmax(x: torch.Tensor, axis: int = -1, dtype=None,
            name=None) -> torch.Tensor:
    """Softmax over ``axis``, in ``dtype`` when given (reference :144)."""
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1, dtype=None,
                name=None) -> torch.Tensor:
    """Log-softmax over ``axis``, in ``dtype`` when given (reference
    :153)."""
    (x,) = amp_cast("log_softmax", x)
    if dtype is not None:
        x = x.to(to_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
             begin_norm_axis: int = -1, name=None) -> torch.Tensor:
    """RMS norm over the last axis in the reference's exact order (:336): f32
    mean of squares -> rsqrt -> cast back to the input dtype -> multiply by
    the weight -> add the bias. ``begin_norm_axis`` must name the last axis
    (-1 or ``x.dim() - 1``); another axis raises ``NotImplementedError``.
    ``name`` is accepted for API parity."""
    if begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            f"rms_norm: begin_norm_axis={begin_norm_axis} (only the last "
            f"axis, -1 or {x.dim() - 1}, is normalised)")
    x, weight, bias = amp_cast("rms_norm", x, weight, bias)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 name=None) -> torch.Tensor:
    """Attention over ``[b, s, h, d]``: the flash kernels on the card, the
    plain version on the CPU (see ``ops/kernels/flash_attention.py``).
    ``name`` is accepted for API parity."""
    from ..ops.kernels.flash_attention import flash_attention_bshd

    return flash_attention_bshd(query, key, value, causal=is_causal,
                                mask=attn_mask,
                                dropout=dropout_p if training else 0.0)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """``(out, None)``: the softmax is never returned, as in the reference
    (:1206, same argument order). A dropout draws from a generator seeded
    with ``fixed_seed_offset`` when given, else from the named generator
    ``rng_name`` of ``core.random`` (the default one for ``""``)."""
    from ..core import random
    from ..ops.kernels.flash_attention import flash_attention_bshd

    drop = float(dropout) if training else 0.0
    gen = (random.dropout_generator(query.device, fixed_seed_offset,
                                    rng_name) if drop > 0.0 else None)
    out = flash_attention_bshd(query, key, value, causal=causal,
                               dropout=drop, generator=gen)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, fixed_seed_offset=None,
                        rng_name: str = "", training: bool = True,
                        name=None):
    """Packed varlen attention (reference flash_attention.py:762): the
    varlen kernels on the card, the plain version on the CPU (see
    ``ops/kernels/flash_varlen.py``). Returns ``(out, None)``.
    ``fixed_seed_offset`` reaches the dropout, where the JAX package's
    functional wrapper (:1215) drops it."""
    from ..ops.kernels.flash_varlen import flash_attn_unpadded as _impl

    return _impl(query, key, value, cu_seqlens_q, cu_seqlens_k,
                 max_seqlen_q=max_seqlen_q, max_seqlen_k=max_seqlen_k,
                 scale=scale, dropout=dropout, causal=causal,
                 return_softmax=return_softmax,
                 fixed_seed_offset=fixed_seed_offset, rng_name=rng_name,
                 training=training)


# ---------------------------------------------------------------------------
# losses (reference nn/functional.py :909-1083)
# ---------------------------------------------------------------------------


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _pick(logp: torch.Tensor, index: torch.Tensor, axis: int) -> torch.Tensor:
    """``logp``'s entry at ``index`` along ``axis`` (``index`` has ``logp``'s
    shape without that axis)."""
    axis = axis % logp.dim()
    return logp.gather(axis, index.unsqueeze(axis)).squeeze(axis)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy in f32 (reference :920-957, the same branches).

    * ``use_softmax`` takes ``input`` as logits (log-softmax over ``axis``),
      otherwise as probabilities (their log, floored at 1e-30).
    * Soft labels (``soft_label``, or a label of ``input``'s shape):
      ``-sum(target * logp)``, the target smoothed to ``target (1 - ls) +
      ls / classes`` by ``label_smoothing``; every row counts.
    * Hard labels: ``-logp[label]`` (a label with a trailing axis of 1 is
      squeezed), mixed by ``label_smoothing`` with the mean ``logp`` of the
      row; rows whose label is ``ignore_index`` count 0. With ``weight``,
      each row is scaled by ``weight[label]`` and ``"mean"`` divides by
      ``sum(weight[label] * valid)``; without, by the number of valid rows.
    * ``reduction``: "mean", "sum" or "none"."""
    input, label, weight = amp_cast("cross_entropy", input, label, weight)
    lf = input.float()
    if use_softmax:
        logp = torch.log_softmax(lf, dim=axis)
    else:
        logp = torch.log(torch.clamp(lf, min=1e-30))
    n_classes = input.shape[axis]
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape):
        tgt = label.float()
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(tgt * logp).sum(dim=axis)
        valid = torch.ones_like(loss)
    else:
        lab = label.long()
        if lab.dim() == input.dim():
            lab = lab.squeeze(axis)
        valid = (lab != ignore_index).float()
        safe = torch.where(lab == ignore_index, torch.zeros_like(lab), lab)
        picked = _pick(logp, safe, axis)
        if label_smoothing > 0:
            smooth = logp.mean(dim=axis)
            picked = (1 - label_smoothing) * picked + label_smoothing * smooth
        loss = -picked * valid
        if weight is not None:
            w_row = weight[safe]
            loss = loss * w_row
            if reduction == "mean":
                return loss.sum() / torch.clamp((w_row * valid).sum(),
                                                min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1e-12)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row cross entropy with ``axis`` kept as 1 (reference :960), and
    the softmax with it when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast(None, input, label)
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast(None, input, label)
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = amp_cast(None, input, label)
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` over log-probabilities ``input [..., C]``, rows of
    ``ignore_index`` counted 0, weighted by ``weight[label]``; "mean"
    divides by the summed row weights (reference :992)."""
    input, label, weight = amp_cast(None, input, label, weight)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = -_pick(input, safe, -1)
    wv = valid.to(picked.dtype)
    if weight is not None:
        wv = wv * weight[safe]
    picked = picked * wv
    if reduction == "mean":
        return picked.sum() / torch.clamp(wv.sum(), min=1e-12)
    return _reduce(picked, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = amp_cast(None, input, label, weight)
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z y + log1p(exp(-|z|))``; with ``pos_weight`` the
    log term is scaled by ``1 + (pos_weight - 1) y``, as in the reference
    (:1010)."""
    logit, label, weight, pos_weight = amp_cast(None, logit, label, weight,
                                                pos_weight)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        soft = (1 + (pos_weight - 1) * label) * soft
    base = torch.clamp(logit, min=0) - logit * label + soft
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    input, label = amp_cast(None, input, label)
    target = torch.exp(label) if log_target else label
    log_t = label if log_target else torch.log(torch.clamp(label, min=1e-12))
    pointwise = target * (log_t - input)
    if reduction == "batchmean":
        return pointwise.sum() / input.shape[0]
    return _reduce(pointwise, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = amp_cast(None, x1, x2)
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.sqrt((x1 * x1).sum(dim=axis))
    n2 = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    sim = cosine_similarity(input1, input2, axis=-1)
    sim, label = amp_cast(None, sim, label)
    loss = torch.where(label == 1, 1 - sim, torch.clamp(sim - margin, min=0.0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp_cast(None, input, other, label)
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = amp_cast(None, input, label)
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(d(a, pos) - d(a, neg) + margin, 0)`` with p-norm distances
    over the last axis (``swap``: the smaller of d(a, neg) and d(pos,
    neg)). ``epsilon`` is accepted and, as in the reference, not read."""
    input, positive, negative = amp_cast(None, input, positive, negative)

    def dist(a, b):
        return (torch.abs(a - b) ** p).sum(dim=-1) ** (1 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)
