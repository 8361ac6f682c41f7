"""Model multiplexing: many models per deployment, LRU per replica.

A copy of ``ray_tpu/serve/multiplex.py``. Reference analog: ``serve/multiplex.py`` (``_ModelMultiplexWrapper:23``)
and ``serve/api.py:575`` (``@serve.multiplexed``). A deployment method
decorated with ``@serve.multiplexed(max_num_models_per_replica=N)``
loads a model by id; the wrapper keeps an LRU of loaded models per
replica (evicting with ``__del__``-style drop), and the router prefers
replicas that already hold the requested model (cache-affinity routing)
over cold ones.

Request flow: ``handle.options(multiplexed_model_id="m1").remote(x)`` —
the id rides the request as a reserved kwarg, the replica sets the
request context, and user code calls
``serve.get_multiplexed_model_id()`` inside the loader/handler.
"""

from __future__ import annotations

import contextvars
import functools
import threading
from collections import OrderedDict

MODEL_ID_KWARG = "__serve_multiplexed_model_id__"

_request_model_id: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("serve_multiplexed_model_id", default=None)


def get_multiplexed_model_id() -> str | None:
    """Inside a request: the model id this request was routed with."""
    return _request_model_id.get()


def set_request_model_id(model_id: str | None):
    return _request_model_id.set(model_id)


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for the model-loader method of a deployment class:

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str): ...

    Calls are LRU-cached per model id; eviction drops the oldest model.
    """

    def wrap(fn):
        attr = f"__serve_multiplex_state_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self, model_id: str | None = None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            if model_id is None:
                raise ValueError(
                    "no model id: pass one or route the request with "
                    "handle.options(multiplexed_model_id=...)")
            state = self.__dict__.setdefault(
                attr, {"models": OrderedDict(), "lock": threading.Lock()})
            with state["lock"]:
                if model_id in state["models"]:
                    state["models"].move_to_end(model_id)
                    return state["models"][model_id]
            model = fn(self, model_id)  # load OUTSIDE the lock (slow)
            with state["lock"]:
                state["models"][model_id] = model
                state["models"].move_to_end(model_id)
                while len(state["models"]) > max_num_models_per_replica:
                    state["models"].popitem(last=False)
            return model

        wrapper.__serve_multiplexed__ = True
        return wrapper

    return wrap if _fn is None else wrap(_fn)


def loaded_model_ids(instance) -> list[str]:
    """All model ids currently cached on a replica instance (across its
    multiplexed methods)."""
    out: list[str] = []
    for key, state in instance.__dict__.items():
        if key.startswith("__serve_multiplex_state_"):
            out.extend(state["models"].keys())
    return out
