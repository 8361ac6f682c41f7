"""Lazy DAG authoring with ``.bind()`` (port of ``ray_tpu/dag``;
reference: ``python/ray/dag/``).

``fn.bind(*args)`` builds a ``DAGNode`` without running it; nodes compose
into a DAG whose ``execute()`` submits the whole graph as the port's
tasks, upstream results passed as ObjectRef arguments (so intermediate
values never reach the driver). ``workflow`` runs the same graphs with a
checkpoint a step.
"""

from __future__ import annotations

from typing import Any

import ray_tpu_torch


class DAGNode:
    def __init__(self, fn, args, kwargs, *, options=None):
        self._fn = fn
        self._args = args
        self._kwargs = kwargs
        self._options = options or {}

    # -- traversal -------------------------------------------------------
    def _upstream(self) -> list["DAGNode"]:
        out = [a for a in self._args if isinstance(a, DAGNode)]
        out += [v for v in self._kwargs.values() if isinstance(v, DAGNode)]
        return out

    def topo_order(self) -> list["DAGNode"]:
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen.add(id(node))
            for up in node._upstream():
                visit(up)
            order.append(node)

        visit(self)
        return order

    # -- execution -------------------------------------------------------
    def execute(self) -> Any:
        """Submit the DAG; returns the final ObjectRef."""
        refs: dict[int, Any] = {}
        for node in self.topo_order():
            args = [refs[id(a)] if isinstance(a, DAGNode) else a
                    for a in node._args]
            kwargs = {k: refs[id(v)] if isinstance(v, DAGNode) else v
                      for k, v in node._kwargs.items()}
            remote_fn = ray_tpu_torch.remote(node._fn)
            # workflow_* options are consumed by workflow.run's step
            # driver, not the task API
            opts = {k: v for k, v in (node._options or {}).items()
                    if not k.startswith("workflow_")}
            if opts:
                remote_fn = remote_fn.options(**opts)
            refs[id(node)] = remote_fn.remote(*args, **kwargs)
        return refs[id(self)]

    def options(self, **opts) -> "DAGNode":
        return DAGNode(self._fn, self._args, self._kwargs, options=opts)

    def __repr__(self):
        return f"DAGNode({getattr(self._fn, '__name__', '?')})"


class InputNode(DAGNode):
    """Placeholder for runtime input (reference: ``dag/input_node.py``)."""

    def __init__(self):
        super().__init__(None, (), {})
        self._value = None

    def execute(self):
        raise TypeError("InputNode cannot be executed directly")


def bind(fn, *args, **kwargs) -> DAGNode:
    """Functional form: ``dag.bind(f, x)`` == f.bind(x)."""
    options = None
    if hasattr(fn, "underlying_function"):  # RemoteFunction from @remote
        options = getattr(fn, "_options", None)
        fn = fn.underlying_function
    return DAGNode(fn, args, kwargs, options=options)


def execute_with_input(root: DAGNode, input_value) -> Any:
    """Execute a DAG containing an InputNode, substituting the value."""
    refs: dict[int, Any] = {}
    for node in root.topo_order():
        if isinstance(node, InputNode):
            refs[id(node)] = input_value
            continue
        args = [refs[id(a)] if isinstance(a, DAGNode) else a
                for a in node._args]
        kwargs = {k: refs[id(v)] if isinstance(v, DAGNode) else v
                  for k, v in node._kwargs.items()}
        remote_fn = ray_tpu_torch.remote(node._fn)
        if node._options:
            remote_fn = remote_fn.options(**node._options)
        refs[id(node)] = remote_fn.remote(*args, **kwargs)
    return refs[id(root)]
