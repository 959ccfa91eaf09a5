"""paddle.distributed.utils (counterpart of
``paddlepaddle_tpu/distributed/utils.py``): the MoE
``global_scatter`` / ``global_gather`` helpers.

They are the reference stack's hand-rolled all_to_all of expert dispatch.
The JAX package raises for them, pointing at its MoE layer; the port does
the same: its expert path is :mod:`..parallel.moe` (``MoELayer`` over an
``ep`` axis, experts on their ranks, kernel 8 on each rank's local
banks), which dispatches by replicated tokens and an ``ep`` all-reduce.
"""

from __future__ import annotations

_HINT = ("is the reference's hand-rolled MoE all_to_all; in "
         "paddlepaddle_tpu_torch use parallel.moe.MoELayer over an 'ep' "
         "mesh axis (ShardedTrainStep with moe_train_rules()), which "
         "dispatches to each rank's local experts itself")


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    raise NotImplementedError(f"global_scatter {_HINT}")


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    raise NotImplementedError(f"global_gather {_HINT}")
