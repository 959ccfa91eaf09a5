"""AMP op lists: the port's own copy of the reference's
(``paddlepaddle_tpu/amp/amp_lists.py``, after python/paddle/amp/amp_lists.py).

White list: compute-bound ops that are numerically safe and fast in
bf16/fp16 (tensor-core ops). Black list: reductions and exponentials that
need f32. The names are the reference's op names; the port's entry points
that carry one pass it to :func:`..amp.amp_cast`."""

WHITE_LIST = frozenset({
    "matmul",
    "bmm",
    "mm",
    "mv",
    "linear",
    "conv1d",
    "conv2d",
    "conv3d",
    "conv2d_transpose",
    "einsum",
    "flash_attention",
    "ring_flash_attention",
    "addmm",
})

BLACK_LIST = frozenset({
    "exp",
    "square",
    "log",
    "log2",
    "log10",
    "log1p",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "log_softmax",
    "softmax_with_cross_entropy",
    "cross_entropy",
    "nll_loss",
    "layer_norm",
    "rms_norm",
    "batch_norm",
    "group_norm",
    "cumsum",
    "logsumexp",
    "erf",
    "erfinv",
    "pow",
    "norm",
    "var",
    "std",
    "renorm",
    "mse_loss",
    "kl_div",
    "binary_cross_entropy",
    "binary_cross_entropy_with_logits",
})
