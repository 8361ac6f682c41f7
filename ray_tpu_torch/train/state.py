"""Train state: parameters, optimizer state and step.

Port of ``ray_tpu/train/state.py``. Placing the state over a mesh
(``state_logical_axes``) is not ported yet. The state's tensors are
updated in place by ``Trainer.train_step``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0

    @staticmethod
    def create(params: dict, optimizer) -> "TrainState":
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0)
