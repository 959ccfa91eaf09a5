"""``stream.*`` collective variants (counterpart of
``paddlepaddle_tpu/distributed/communication/stream.py``): each takes
``sync_op`` / ``use_calc_stream`` and returns a waitable task. The ops are
issued at call time on the current stream, so ``use_calc_stream=True`` and
``sync_op=True`` return a completed task; ``sync_op=False`` defers a device
sync to ``task.wait()``."""

from __future__ import annotations

import functools

import torch

from .. import collective as _c


class _StreamTask:
    def __init__(self, sync: bool):
        self._done = sync

    def wait(self):
        if not self._done:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.current_stream().synchronize()
            self._done = True
        return True

    def is_completed(self):
        return self._done


def _stream_op(fn):
    @functools.wraps(fn)
    def wrapper(*args, sync_op=True, use_calc_stream=False, **kwargs):
        fn(*args, **kwargs)
        return _StreamTask(sync=bool(sync_op or use_calc_stream))

    wrapper.__doc__ = (f"stream variant of collective.{fn.__name__}: returns "
                       "a waitable task; sync_op=False defers the device "
                       "sync to task.wait()")
    return wrapper


all_gather = _stream_op(_c.all_gather)
all_reduce = _stream_op(_c.all_reduce)
all_to_all = _stream_op(_c.all_to_all)
broadcast = _stream_op(_c.broadcast)
recv = _stream_op(_c.recv)
reduce = _stream_op(_c.reduce)
reduce_scatter = _stream_op(_c.reduce_scatter)
scatter = _stream_op(_c.scatter)
send = _stream_op(_c.send)
