"""``paddle.distributed.communication`` (counterpart of
``paddlepaddle_tpu/distributed/communication/__init__.py``): the collective
API re-exported, ``P2POp`` / ``batch_isend_irecv`` over
``torch.distributed``'s point-to-point ops, and the :mod:`.stream`
variants."""

from ..collective import (  # noqa: F401
    ReduceOp,
    _Task,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    irecv,
    isend,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from . import stream  # noqa: F401

_OP_NAMES = {"isend": isend, "irecv": irecv, "send": send, "recv": recv}


class P2POp:
    """One point-to-point op of a batch: ``op`` is ``isend`` / ``irecv``
    (or ``send`` / ``recv``; their names accepted), ``tensor`` the buffer,
    ``peer`` the remote global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if isinstance(op, str):
            op = _OP_NAMES.get(op)
        if op not in (isend, irecv, send, recv):
            raise ValueError(
                "P2POp.op must be paddle.distributed isend/irecv (or "
                f"send/recv), got {op!r}")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Run a batch of P2P ops and return one completed task per op. Every
    send is posted (non-blocking) before any receive is waited on, so the
    order of the two ranks' lists cannot deadlock."""
    if not p2p_op_list:
        raise ValueError("batch_isend_irecv expects a non-empty op list")
    for p in p2p_op_list:
        if not isinstance(p, P2POp):
            raise ValueError(f"expected P2POp, got {type(p).__name__}")
    tasks = [None] * len(p2p_op_list)
    for i, p in enumerate(p2p_op_list):
        if p.op in (isend, send):
            tasks[i] = isend(p.tensor, dst=p.peer, group=p.group)
    for i, p in enumerate(p2p_op_list):
        if p.op in (irecv, recv):
            tasks[i] = irecv(p.tensor, src=p.peer, group=p.group)
    for t in tasks:
        t.wait()
    return tasks
