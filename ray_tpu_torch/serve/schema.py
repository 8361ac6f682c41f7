"""Declarative Serve config: build/apply deployments from dict, JSON or YAML.

Port of ``ray_tpu/serve/schema.py``: the same schema, two-phase
build-then-deploy and error texts. ``resources_per_replica`` names the
card ``GPU`` (JAX's ``TPU``). ``apply_config_file`` reads JSON itself; a
file that is not JSON goes through ``yaml`` where that is importable.

Reference analog: ``serve/schema.py`` (ServeDeploySchema /
ServeApplicationSchema pydantic models behind the REST config and the
``serve deploy config.yaml`` CLI). Shape:

.. code-block:: yaml

    applications:
      - name: app1
        deployments:
          - name: Summarizer            # optional override
            import_path: my_module:summarizer   # a Deployment object
            num_replicas: 2
            init_args: ["en"]
            init_kwargs: {beam: 4}
            user_config: {temperature: 0.2}
            max_concurrent_queries: 16
            autoscaling_config: {min_replicas: 1, max_replicas: 4}

``import_path`` is ``module:attr`` or ``module.attr`` resolving to a
``Deployment`` (bound or not). ``apply_config`` deploys every entry and
returns {deployment_name: DeploymentHandle}. Init-arg layering:
``init_args`` in the config REPLACES the target's bound positionals
when present (otherwise they are kept), and ``init_kwargs`` MERGES over
the target's bound kwargs key by key. The whole config is built and
validated before anything deploys, so a config error (bad import path,
unknown field, name collision) in any entry leaves nothing running; a
RUNTIME failure while deploying entry N (replica init raising,
resources never scheduling) can still leave entries before it live —
the controller keeps them and the raised error names the failed entry.
Validation errors name the offending field —
there is no pydantic in the image, so a small hand validator plays that
role.
"""

from __future__ import annotations

import importlib

import json

from ray_tpu_torch.serve import api as _api

_DEPLOYMENT_FIELDS = {
    "name", "import_path", "num_replicas", "init_args", "init_kwargs",
    "user_config", "max_concurrent_queries", "autoscaling_config",
    "resources_per_replica",
}


def import_attr(path: str):
    """Resolve ``module:attr`` (preferred) or dotted ``module.attr``."""
    if ":" in path:
        mod_name, _, attr = path.partition(":")
    else:
        mod_name, _, attr = path.rpartition(".")
    if not mod_name or not attr:
        raise ValueError(f"malformed import_path {path!r} "
                         "(want module:attr)")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise ValueError(
            f"import_path {path!r}: module {mod_name!r} has no "
            f"attribute {attr!r}") from None


def _validate_deployment(spec: dict, where: str):
    if not isinstance(spec, dict):
        raise ValueError(f"{where}: deployment entry must be a mapping")
    unknown = set(spec) - _DEPLOYMENT_FIELDS
    if unknown:
        raise ValueError(
            f"{where}: unknown field(s) {sorted(unknown)}; "
            f"allowed: {sorted(_DEPLOYMENT_FIELDS)}")
    if "import_path" not in spec:
        raise ValueError(f"{where}: import_path is required")


def _build_one(spec: dict, where: str) -> "_api.Deployment":
    _validate_deployment(spec, where)
    target = import_attr(spec["import_path"])
    if not isinstance(target, _api.Deployment):
        raise ValueError(
            f"{where}: {spec['import_path']!r} resolved to "
            f"{type(target).__name__}, expected a @serve.deployment")
    auto = spec.get("autoscaling_config")
    if isinstance(auto, dict):
        from ray_tpu_torch.serve.config import AutoscalingConfig

        try:
            auto = AutoscalingConfig(**auto)
        except TypeError as e:
            raise ValueError(f"{where}: bad autoscaling_config: {e}") \
                from None
    dep = target.options(
        name=spec.get("name"),
        num_replicas=spec.get("num_replicas"),
        max_concurrent_queries=spec.get("max_concurrent_queries"),
        autoscaling_config=auto,
        user_config=spec.get("user_config"),
        resources_per_replica=spec.get("resources_per_replica"),
    )
    if "init_args" in spec or "init_kwargs" in spec:
        # config args layer over whatever the import target bound:
        # init_args replaces positionals only when present; init_kwargs
        # merges over bound kwargs
        args = spec.get("init_args", target._init_args)
        kwargs = {**target._init_kwargs, **spec.get("init_kwargs", {})}
        dep = dep.bind(*args, **kwargs)
    return dep


def apply_config(config: dict) -> dict:
    """Deploy every deployment in a config dict; returns
    {deployment_name: handle}. Accepts either the full two-level
    ``{"applications": [{"deployments": [...]}]}`` schema or a flat
    ``{"deployments": [...]}``."""
    if not isinstance(config, dict):
        raise ValueError("serve config must be a mapping")
    unknown = set(config) - {"applications", "deployments"}
    if unknown:
        raise ValueError(
            f"unknown top-level field(s) {sorted(unknown)}; expected "
            "'applications' or 'deployments'")
    apps = config.get("applications")
    if apps is None:
        if "deployments" not in config:
            raise ValueError(
                "config must contain 'applications' or 'deployments'")
        apps = [{"name": "default", "deployments":
                 config.get("deployments", [])}]
    # Phase 1: build + validate EVERYTHING (imports, fields, name
    # collisions) before any deployment goes live, so a CONFIG error in
    # entry N cannot leave entries 0..N-1 running. (Runtime deploy
    # failures in phase 2 are not rolled back — see module docstring.)
    built: list = []
    owner: dict = {}   # deployment name -> application that declared it
    for ai, app in enumerate(apps):
        if not isinstance(app, dict) or "deployments" not in app:
            raise ValueError(
                f"applications[{ai}]: expected a mapping with a "
                "'deployments' list")
        app_name = app.get("name", f"applications[{ai}]")
        for di, spec in enumerate(app["deployments"]):
            where = (f"applications[{ai}].deployments[{di}]"
                     if "applications" in config else f"deployments[{di}]")
            dep = _build_one(spec, where)
            if dep.name in owner:
                # deployment names are cluster-global here: a second app
                # reusing one would silently clobber the first
                raise ValueError(
                    f"{where}: deployment name {dep.name!r} already "
                    f"declared by {owner[dep.name]!r}; rename one "
                    "(names are global)")
            owner[dep.name] = app_name
            built.append(dep)
    # Phase 2: deploy
    return {dep.name: _api.run(dep) for dep in built}


def apply_config_file(path: str) -> dict:
    """JSON (or YAML, where ``yaml`` is importable) config file →
    apply_config."""
    with open(path) as f:
        text = f.read()
    try:
        config = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise ImportError(
                f"{path}: not JSON, and reading it as YAML needs the "
                "'yaml' package, which is not installed; apply_config_file "
                "reads JSON without it") from None
        config = yaml.safe_load(text)
    return apply_config(config)
