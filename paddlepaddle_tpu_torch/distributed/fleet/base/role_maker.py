"""Role makers (counterpart of
``paddlepaddle_tpu/distributed/fleet/base/role_maker.py``; reference:
fleet/base/role_maker.py). Collective jobs take their rank and world from
the launcher's environment; the parameter-server roles are out of scope,
as in the JAX package."""

from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2


class PaddleCloudRoleMaker:
    """Reads the launch environment (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM,
    or torch-style RANK / WORLD_SIZE)."""

    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self) -> int:
        return int(os.environ.get("PADDLE_TRAINER_ID")
                   or os.environ.get("RANK") or 0)

    def _worker_num(self) -> int:
        return int(os.environ.get("PADDLE_TRAINERS_NUM")
                   or os.environ.get("WORLD_SIZE") or 1)

    worker_index = _worker_index
    worker_num = _worker_num

    def _is_worker(self) -> bool:
        return True

    def _is_server(self) -> bool:
        return False  # PS roles out of TPU scope

    def _role_id(self) -> int:
        return self._worker_index()


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective: bool = True, current_id: int = 0,
                 worker_num: int = 1, **kwargs):
        super().__init__(is_collective=is_collective)
        self._id = int(current_id)
        self._num = int(worker_num)

    def _worker_index(self) -> int:
        return self._id

    def _worker_num(self) -> int:
        return self._num

    worker_index = _worker_index
    worker_num = _worker_num
