"""Weight carry-over from the JAX package's parameter pytree.

The one bridge between the two packages' weights: the caller converts the
JAX pytree with ``np.asarray`` (``jax.tree.map(np.asarray, params)``) and
hands the numpy tree here. Names and layouts are the same on both sides
(stacked ``[L, ...]`` blocks, ``x @ W`` orientation) for every model
family, so the mapping is name for name. The RL policy/value module
(``policy_value_from_numpy``) takes the tree of JAX's
``rllib.ppo.init_module``, which is also RLlib's checkpoint format; SAC's
and TD3's trees (``mlp_tree_from_numpy``), the recurrent core's
(``recurrent_from_numpy``) and DreamerV3's (``dreamer_from_numpy``) map
the same way, and so do their Adam moments, which have the parameters'
structure.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _family_of(cfg):
    """The model module of a config: llama, mixtral, gpt, bert or vit."""
    from ray_tpu_torch.models import bert, gpt, llama, mixtral, vit

    for family, config in ((llama, llama.LlamaConfig),
                           (mixtral, mixtral.MixtralConfig),
                           (gpt, gpt.GPTConfig), (bert, bert.BertConfig),
                           (vit, vit.ViTConfig)):
        if isinstance(cfg, config):
            return family
    raise TypeError(f"no model family for config {type(cfg).__name__}")


def _to_tensor(a, device, dtype):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides it): carry
        # the bits across unchanged
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        # a copy: the tree's arrays may be read-only views of JAX buffers
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _in_dtype(cfg, dtype: torch.dtype):
    """``cfg`` with its parameter dtype set to ``dtype`` (a dtype name in
    ``dtype`` for the language models, a torch dtype in ViT's
    ``param_dtype``)."""
    if isinstance(getattr(cfg, "dtype", None), str):
        return dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
    return dataclasses.replace(cfg, param_dtype=dtype)


def params_from_numpy(cfg, tree: dict, *, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """The port's parameter dictionary from a numpy parameter tree of the
    family of ``cfg``. The tree must have the family's structure: the keys
    and shapes of its ``init_params`` (taken on the meta device, so nothing
    is allocated). Each leaf keeps its own dtype unless ``dtype`` is given;
    then each leaf takes the dtype that ``init_params`` gives it in a
    ``dtype`` model, so the leaves a family holds in float32 whatever its
    dtype (the Mixtral router, BERT's ``mlm_bias``) stay float32."""
    dev = resolve_device(device)
    expected = _family_of(cfg).init_params(
        cfg if dtype is None else _in_dtype(cfg, dtype), device="meta")

    def convert(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"parameter tree{path} has keys {got}, "
                                 f"expected {sorted(want)}")
            return {k: convert(node[k], want[k], f"{path}.{k}")
                    for k in want}
        if isinstance(node, dict) or np.shape(node) != tuple(want.shape):
            raise ValueError(f"parameter {path[1:]} has shape "
                             f"{np.shape(node)}, expected {tuple(want.shape)}")
        return _to_tensor(node, dev, None if dtype is None else want.dtype)

    return convert(tree, expected, "")


def policy_value_from_numpy(tree: dict, *, device="cuda"):
    """The port's ``rllib.ppo.PolicyValueMLP`` from the numpy tree of JAX's
    ``init_module`` (``ray_tpu/rllib/ppo.py:30``): ``{layer: {"w": [fan_in,
    fan_out], "b": [fan_out]}}`` for the layers torso1, torso2, pi and vf,
    ``w`` kept in that layout (the module computes ``x @ w + b``). Raises
    unless the keys are those and the shapes chain: obs -> hidden ->
    hidden, then hidden -> actions and hidden -> 1."""
    from ray_tpu_torch.rllib.ppo import LAYERS, PolicyValueMLP

    dev = resolve_device(device)
    if not isinstance(tree, dict) or set(tree) != set(LAYERS) or any(
            not isinstance(tree[k], dict) or set(tree[k]) != {"w", "b"}
            for k in LAYERS):
        raise ValueError(f"not a policy/value tree: expected {LAYERS}, each "
                         "with 'w' and 'b'")
    shapes = {k: (np.shape(tree[k]["w"]), np.shape(tree[k]["b"]))
              for k in LAYERS}
    obs, hidden = (shapes["torso1"][0] + (None, None))[:2]
    n_actions = (shapes["pi"][0] + (None, None))[1]
    want = {"torso1": ((obs, hidden), (hidden,)),
            "torso2": ((hidden, hidden), (hidden,)),
            "pi": ((hidden, n_actions), (n_actions,)),
            "vf": ((hidden, 1), (1,))}
    if shapes != want:
        raise ValueError(f"policy/value tree has shapes {shapes}, expected "
                         f"{want}")
    return PolicyValueMLP({k: {leaf: _to_tensor(tree[k][leaf], dev, None)
                               for leaf in ("w", "b")}
                           for k in LAYERS})


def mlp_tree_from_numpy(tree: dict, *, device="cuda") -> dict:
    """The port's SAC or TD3 parameter tree from the numpy tree of JAX's
    ``init_sac`` (``ray_tpu/rllib/sac.py:49``: ``{"actor", "q1", "q2",
    "log_alpha"}``; SAC's target critics ``{"q1", "q2"}``) or ``init_td3``
    (``ray_tpu/rllib/td3.py:28``: ``{"actor", "q1"[, "q2"]}``), each
    network a list of layers ``{"w": [fan_in, fan_out], "b": [fan_out]}``.
    The leaves become tensors on ``device`` that take gradients. Raises
    unless the keys are one of those sets, each network's shapes chain,
    the critics map one input width to one value and, with an actor, that
    width is [obs, action] for the actor's action (SAC's: its mean and
    log-std)."""
    dev = resolve_device(device)
    keysets = ({"actor", "q1", "q2", "log_alpha"}, {"actor", "q1", "q2"},
               {"actor", "q1"}, {"q1", "q2"})
    if not isinstance(tree, dict) or set(tree) not in keysets:
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"not a SAC or TD3 tree: keys {got}")

    def widths(name):
        net = tree[name]
        if not isinstance(net, list) or not net or any(
                not isinstance(layer, dict) or set(layer) != {"w", "b"}
                for layer in net):
            raise ValueError(f"{name} is not a list of {{'w', 'b'}} layers")
        shapes = [(np.shape(layer["w"]), np.shape(layer["b"]))
                  for layer in net]
        if not all(len(w) == 2 and b == (w[1],) for w, b in shapes) or any(
                a[0][1] != b[0][0] for a, b in zip(shapes, shapes[1:])):
            raise ValueError(f"{name}'s layers do not chain: {shapes}")
        return shapes[0][0][0], shapes[-1][0][1]

    critics = sorted(tree.keys() - {"actor", "log_alpha"})
    q_in = widths("q1")[0]
    if "actor" in tree:
        obs_dim, out = widths("actor")
        sac = "log_alpha" in tree
        if sac and out % 2:
            raise ValueError(f"SAC's actor outputs {out}, not a mean and a "
                             "log-std per action")
        q_in = obs_dim + (out // 2 if sac else out)
    for name in critics:
        if widths(name) != (q_in, 1):
            raise ValueError(f"{name} maps {widths(name)}, expected "
                             f"{(q_in, 1)}")
    if "log_alpha" in tree and np.shape(tree["log_alpha"]) != ():
        raise ValueError(f"log_alpha has shape {np.shape(tree['log_alpha'])}"
                         ", expected ()")

    def leaf(a):
        return _to_tensor(a, dev, None).requires_grad_()

    # the port's order (its optimizer state is positional), not the tree's
    return {k: (leaf(tree[k]) if k == "log_alpha" else
                [{"w": leaf(layer["w"]), "b": leaf(layer["b"])}
                 for layer in tree[k]])
            for k in ("actor", "q1", "q2", "log_alpha") if k in tree}


def recurrent_from_numpy(tree: dict, *, cell_type: str | None = None,
                         device="cuda"):
    """The port's ``rllib.recurrent.RecurrentModule`` from the numpy tree
    of JAX's ``init_recurrent_module`` (``ray_tpu/rllib/recurrent.py:44``):
    ``{"cell_type", "enc", "cell", "pi", "vf"}``, each layer ``{"w":
    [fan_in, fan_out], "b": [fan_out]}``. ``cell_type`` may come as the
    keyword instead (JAX's learners and Adam moments hold the tree
    without it). Raises unless the layers are those and the shapes chain:
    obs -> hidden, [2*hidden] -> gates*hidden (3 for gru, 4 for lstm),
    then hidden -> actions and hidden -> 1."""
    from ray_tpu_torch.rllib.recurrent import LAYERS, RecurrentModule

    dev = resolve_device(device)
    if not isinstance(tree, dict):
        raise ValueError(f"not a recurrent tree: {type(tree)}")
    cell = tree.get("cell_type", cell_type)
    if cell_type is not None and cell != cell_type:
        raise ValueError(f"the tree's cell_type {cell!r} is not "
                         f"{cell_type!r}")
    if cell not in ("gru", "lstm"):
        raise ValueError(f"cell_type must be 'gru' or 'lstm', got {cell!r}")
    layers = {k: v for k, v in tree.items() if k != "cell_type"}
    if set(layers) != set(LAYERS) or any(
            not isinstance(layers[k], dict) or set(layers[k]) != {"w", "b"}
            for k in LAYERS):
        raise ValueError(f"not a recurrent tree: expected {LAYERS}, each "
                         "with 'w' and 'b'")
    shapes = {k: (np.shape(layers[k]["w"]), np.shape(layers[k]["b"]))
              for k in LAYERS}
    obs, hidden = (shapes["enc"][0] + (None, None))[:2]
    n_actions = (shapes["pi"][0] + (None, None))[1]
    gates = 3 if cell == "gru" else 4
    want = {"enc": ((obs, hidden), (hidden,)),
            "cell": ((2 * hidden, gates * hidden), (gates * hidden,)),
            "pi": ((hidden, n_actions), (n_actions,)),
            "vf": ((hidden, 1), (1,))}
    if shapes != want:
        raise ValueError(f"{cell} tree has shapes {shapes}, expected {want}")
    return RecurrentModule({k: {leaf: _to_tensor(layers[k][leaf], dev, None)
                                for leaf in ("w", "b")} for k in LAYERS},
                           cell).to(dev)


DREAMER_WM = ("encoder", "gru", "prior", "post", "decoder", "reward", "cont")


def dreamer_from_numpy(tree: dict, *, device="cuda") -> dict:
    """The port's DreamerV3 tree from the numpy tree of JAX's
    ``init_dreamer`` (``ray_tpu/rllib/dreamer.py:110``): ``{"wm",
    "actor", "critic"}`` (or a part of it: an EMA target critic comes as
    ``{"critic": ...}``, Adam moments of one part as that part), the
    world model ``{"encoder", "gru", "prior", "post", "decoder",
    "reward", "cont"}`` with ``gru`` as ``{"wx": [x, 3h], "wh": [h, 3h],
    "b": [3h]}`` and every other network a list of layers ``{"w":
    [fan_in, fan_out], "b": [fan_out]}``. The leaves become tensors on
    ``device`` that take gradients, in the port's order (its optimizer
    states are positional). Raises unless the keys are those, each
    network's layers chain and the widths agree across networks."""
    dev = resolve_device(device)
    if not isinstance(tree, dict) or not tree or \
            not set(tree) <= {"wm", "actor", "critic"}:
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"not a DreamerV3 tree: keys {got}")

    def mlp(name, net):
        if not isinstance(net, list) or not net or any(
                not isinstance(layer, dict) or set(layer) != {"w", "b"}
                for layer in net):
            raise ValueError(f"{name} is not a list of {{'w', 'b'}} layers")
        shapes = [(np.shape(layer["w"]), np.shape(layer["b"]))
                  for layer in net]
        if not all(len(w) == 2 and b == (w[1],) for w, b in shapes) or any(
                a[0][1] != b[0][0] for a, b in zip(shapes, shapes[1:])):
            raise ValueError(f"{name}'s layers do not chain: {shapes}")
        return shapes[0][0][0], shapes[-1][0][1]

    dims = {}
    if "wm" in tree:
        wm = tree["wm"]
        if not isinstance(wm, dict) or set(wm) != set(DREAMER_WM):
            raise ValueError(f"the world model's keys are not {DREAMER_WM}")
        io = {k: mlp(f"wm.{k}", wm[k]) for k in DREAMER_WM if k != "gru"}
        gru = wm["gru"]
        if not isinstance(gru, dict) or set(gru) != {"wx", "wh", "b"}:
            raise ValueError("wm.gru is not {'wx', 'wh', 'b'}")
        (x_dim, g3), (h_dim, g3h), (gb,) = (np.shape(gru["wx"]),
                                           np.shape(gru["wh"]),
                                           np.shape(gru["b"]))
        obs_dim, embed = io["encoder"]
        z_dim = io["prior"][1]
        f_dim = h_dim + z_dim
        want = {"encoder": (obs_dim, embed), "prior": (h_dim, z_dim),
                "post": (h_dim + embed, z_dim), "decoder": (f_dim, obs_dim),
                "reward": (f_dim, 1), "cont": (f_dim, 1)}
        if io != want or not g3 == g3h == gb == 3 * h_dim or \
                x_dim <= z_dim:
            raise ValueError(
                f"the world model's widths do not agree: {io}, gru "
                f"{np.shape(gru['wx'])} {np.shape(gru['wh'])} "
                f"{np.shape(gru['b'])}")
        dims = {"f_dim": f_dim, "n_actions": x_dim - z_dim}
    for name, out in (("actor", dims.get("n_actions")), ("critic", 1)):
        if name in tree:
            f_in, f_out = mlp(name, tree[name])
            if f_in != dims.get("f_dim", f_in) or f_out != (out or f_out):
                raise ValueError(f"{name} maps {(f_in, f_out)}, expected "
                                 f"{(dims.get('f_dim'), out)}")

    def leaf(a):
        return _to_tensor(a, dev, None).requires_grad_()

    def layers(net):
        return [{"w": leaf(layer["w"]), "b": leaf(layer["b"])}
                for layer in net]

    out = {}
    if "wm" in tree:
        out["wm"] = {k: ({g: leaf(tree["wm"]["gru"][g])
                          for g in ("wx", "wh", "b")} if k == "gru"
                         else layers(tree["wm"][k])) for k in DREAMER_WM}
    for name in ("actor", "critic"):
        if name in tree:
            out[name] = layers(tree[name])
    return out
