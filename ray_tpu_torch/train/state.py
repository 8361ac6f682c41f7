"""Train state: parameters, optimizer state and step, and their logical
axes.

Port of ``ray_tpu/train/state.py``. ``state_logical_axes`` gives the
logical axes of every leaf, which the sharding rules turn into the
state's placement over a mesh (``Trainer.state_shardings``). The state's
tensors are updated in place by ``Trainer.train_step``.
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


def _structure(tree):
    """The nested keys of a dictionary tree (leaves as None)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _axes_tree(param_axes):
    from ray_tpu_torch.parallel.sharding import Axes

    if isinstance(param_axes, dict):
        return {k: _axes_tree(v) for k, v in param_axes.items()}
    return Axes(param_axes)


def state_logical_axes(state: TrainState, param_axes) -> TrainState:
    """Logical-axis tree for a TrainState: the optimizer's moments (any
    subtree of the optimizer state with the parameters' structure, matched
    by keys, not by shapes: two parameters of one shape may be placed
    differently) inherit their parameters' axes; every other leaf (the
    step count, scalars) is replicated. Leaves are ``Axes`` markers."""
    from ray_tpu_torch.parallel.sharding import Axes

    axes = _axes_tree(param_axes)
    params_keys = _structure(state.params)

    def annotate(node):
        if isinstance(node, dict):
            if _structure(node) == params_keys:
                return axes
            return {k: annotate(v) for k, v in node.items()}
        return Axes((None,) * len(getattr(node, "shape", ())))

    return TrainState(params=axes, opt_state=annotate(state.opt_state),
                      step=Axes(()))
