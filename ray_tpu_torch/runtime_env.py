"""RuntimeEnv: per-task/actor execution environments.

Port of ``ray_tpu/runtime_env.py``: the same fields, validation, cache
layout and worker-cache key. The cache lives under
``$RAY_TPU_TORCH_RUNTIME_ENV_CACHE`` (default
``~/.ray_tpu_torch/runtime_env_cache``); a worker receives its env as
JSON in ``RAY_TPU_TORCH_RUNTIME_ENV`` and applies it at boot.

Reference analog: ``python/ray/runtime_env/`` (public RuntimeEnv class +
schema) and ``python/ray/_private/runtime_env/`` (P4: plugins, URI cache,
per-node agent). Supported fields:

- ``env_vars``: dict of environment variables visible to the task/actor.
- ``working_dir``: a local directory, snapshotted by content hash into a
  shared cache (the URI-cache analog); workers chdir into the snapshot
  and put it on ``sys.path``.
- ``py_modules``: list of module directories/files added to ``sys.path``
  (cached the same way).
- ``pip``: list of requirement strings (or ``{"packages": [...]}``) —
  installed once per requirement set into a cached virtualenv with
  system-site passthrough (the ``_private/runtime_env/pip.py`` analog);
  workers activate it by prepending its site-packages to ``sys.path``.
- ``config``: opaque dict passed through (reference parity; e.g.
  ``{"setup_timeout_seconds": ...}``).
- ``conda``: an existing conda env NAME, or a spec dict
  (``{"dependencies": [...]}`` — environment.yml content). Cached envs
  are created with the host's conda; workers prepend the env's
  site-packages (reference: ``_private/runtime_env/conda.py``). Hosts
  without conda fail the env FAST (RuntimeEnvSetupError), not silently.
- ``container``: ``{"image": ..., "run_options": [...]}`` — the worker
  process runs INSIDE the container via docker/podman with host
  networking and host IPC (so the shm object store and raylet ports
  keep working — reference: ``_private/runtime_env/container.py``).

Workers are cached per runtime-env key exactly like the reference's
(language, runtime_env)-keyed worker pool (``worker_pool.cc``): tasks
with the same env reuse a warm worker; a different env gets its own.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

class RuntimeEnv(dict):
    """Dict-like (wire-serializable as plain JSON)."""

    def __init__(self, *, env_vars: dict | None = None,
                 working_dir: str | None = None,
                 py_modules: list | None = None,
                 pip: list | dict | None = None,
                 conda: str | dict | None = None,
                 container: dict | None = None,
                 config: dict | None = None, **kwargs):
        if kwargs:
            raise ValueError(f"unknown runtime_env fields: {list(kwargs)}")
        body: dict[str, Any] = {}
        if env_vars:
            if not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in env_vars.items()):
                raise TypeError("env_vars must be str -> str")
            body["env_vars"] = dict(env_vars)
        if working_dir:
            if not os.path.isdir(working_dir):
                raise ValueError(
                    f"working_dir {working_dir!r} is not a directory")
            body["working_dir"] = os.path.abspath(working_dir)
        if py_modules:
            body["py_modules"] = [os.path.abspath(p) for p in py_modules]
        if pip:
            reqs = pip.get("packages") if isinstance(pip, dict) else pip
            if not (isinstance(reqs, list)
                    and all(isinstance(r, str) for r in reqs)):
                raise TypeError(
                    "pip must be a list of requirement strings or "
                    "{'packages': [...]}")
            # local-path requirements resolve against the DRIVER's cwd
            # (like working_dir/py_modules) and keep the cache key from
            # aliasing two different './pkg' paths to one venv. pip
            # semantics: a bare name is a REQUIREMENT even if a same-named
            # directory happens to exist in the cwd — only explicit path
            # prefixes or separator-containing existing paths are local.
            def _localize(r: str) -> str:
                if r.startswith((".", "/", "~")) or (
                        os.sep in r and os.path.exists(r)):
                    return os.path.abspath(os.path.expanduser(r))
                return r

            body["pip"] = [_localize(r) for r in reqs]
        if conda:
            if isinstance(conda, str):
                body["conda"] = conda
            elif isinstance(conda, dict):
                if not conda.get("dependencies"):
                    raise ValueError(
                        "conda spec dict needs a non-empty 'dependencies' "
                        "list (environment.yml content)")
                body["conda"] = dict(conda)
            else:
                raise TypeError(
                    "conda must be an env name or a spec dict")
        if container:
            if not isinstance(container, dict) or "image" not in container:
                raise TypeError(
                    "container must be a dict with at least 'image'")
            opts = container.get("run_options", [])
            if not (isinstance(opts, list)
                    and all(isinstance(o, str) for o in opts)):
                raise TypeError("container.run_options must be [str]")
            body["container"] = {"image": container["image"],
                                 "run_options": list(opts)}
        if config:
            body["config"] = dict(config)
        super().__init__(body)

    def to_dict(self) -> dict:
        return dict(self)


def env_key(runtime_env: dict | None) -> str:
    """Stable identity of a runtime env — the worker-cache key."""
    if not runtime_env:
        return ""
    return hashlib.sha256(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# URI cache (reference: _private/runtime_env/packaging.py — content-hash
# addressed snapshots shared across workers)
# ---------------------------------------------------------------------------

def _cache_root() -> str:
    root = os.environ.get(
        "RAY_TPU_TORCH_RUNTIME_ENV_CACHE",
        os.path.join(os.path.expanduser("~"), ".ray_tpu_torch",
                     "runtime_env_cache"))
    os.makedirs(root, exist_ok=True)
    return root


def _dir_content_hash(path: str) -> str:
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(path)):
        dirnames.sort()
        for fn in sorted(filenames):
            fp = os.path.join(dirpath, fn)
            h.update(os.path.relpath(fp, path).encode())
            try:
                with open(fp, "rb") as f:
                    h.update(f.read())
            except OSError:
                continue
    return h.hexdigest()[:16]


def snapshot_dir(path: str) -> str:
    """Copy `path` into the content-addressed cache; returns the cached
    location. Idempotent AND concurrency-safe: each process stages into
    its own unique tmp dir, and a racing winner is tolerated (same
    content, same key — either copy is correct)."""
    import uuid

    path = os.path.abspath(path)
    digest = _dir_content_hash(path)
    dest = os.path.join(_cache_root(), digest)
    if not os.path.isdir(dest):
        tmp = f"{dest}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        shutil.copytree(path, tmp)
        try:
            os.replace(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(dest):  # lost the race some OTHER way
                raise
    return dest


# ---------------------------------------------------------------------------
# pip plugin (reference: _private/runtime_env/pip.py — per-env virtualenv
# with the requirement set as its identity; here venv + system site
# packages so the installed torch stack stays visible underneath)
# ---------------------------------------------------------------------------

def _pip_env_key(reqs: list[str]) -> str:
    import sys

    ident = json.dumps([f"py{sys.version_info[0]}.{sys.version_info[1]}",
                        reqs])
    return hashlib.sha256(ident.encode()).hexdigest()[:16]


def _venv_site_packages(venv_dir: str) -> str:
    import glob

    hits = glob.glob(os.path.join(venv_dir, "lib", "python*",
                                  "site-packages"))
    if not hits:
        raise FileNotFoundError(f"no site-packages under {venv_dir}")
    return hits[0]


def ensure_pip_env(reqs: list[str]) -> str:
    """Create (once, cached by requirement set) a venv with the packages
    installed; returns its site-packages path. Cross-process safe via an
    exclusive lock; ``--system-site-packages`` keeps the image's baked
    stack importable beneath the env's additions."""
    import fcntl
    import subprocess
    import sys

    root = os.path.join(_cache_root(), "venvs")
    os.makedirs(root, exist_ok=True)
    dest = os.path.join(root, _pip_env_key(reqs))
    ready = os.path.join(dest, ".ray_tpu_ready")
    if os.path.exists(ready):
        return _venv_site_packages(dest)
    with open(dest + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(ready):   # another process built it meanwhile
            return _venv_site_packages(dest)
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages", dest],
            check=True, capture_output=True, timeout=300)
        base = [os.path.join(dest, "bin", "python"), "-m", "pip",
                "install", "--no-input", "--quiet"]
        last = None
        # second attempt disables build isolation: air-gapped hosts can
        # still install local sdists/paths using the system setuptools
        # (build isolation wants to DOWNLOAD its build backend)
        for extra in ((), ("--no-build-isolation",)):
            try:
                subprocess.run([*base, *extra, *reqs], check=True,
                               capture_output=True, text=True,
                               timeout=1800)
                last = None
                break
            except subprocess.CalledProcessError as e:
                last = e
        if last is not None:
            shutil.rmtree(dest, ignore_errors=True)
            raise RuntimeError(
                f"runtime_env pip install failed for {reqs}: "
                f"{last.stderr[-2000:] if last.stderr else last}") \
                from None
        open(ready, "w").close()
    return _venv_site_packages(dest)


# ---------------------------------------------------------------------------
# conda plugin (reference: _private/runtime_env/conda.py — cached env per
# spec; the env's site-packages layers onto the worker's sys.path)
# ---------------------------------------------------------------------------

def _find_conda() -> str | None:
    exe = os.environ.get("CONDA_EXE")
    if exe and os.path.exists(exe):
        return exe
    return shutil.which("conda") or shutil.which("mamba") \
        or shutil.which("micromamba")


def conda_create_commands(spec: dict, dest: str, conda_exe: str) -> list:
    """Command lines that materialize a conda env for ``spec`` at
    ``dest`` (pure — unit-testable without conda installed). The
    environment.yml ``{"pip": [...]}`` dependency subsection becomes a
    second pip-install step inside the env; any other non-string entry
    is an error (silent drops would cache an incomplete env forever)."""
    deps = spec.get("dependencies", [])
    conda_pkgs = [d for d in deps if isinstance(d, str)]
    pip_pkgs: list = []
    for d in deps:
        if isinstance(d, str):
            continue
        if isinstance(d, dict) and list(d.keys()) == ["pip"]:
            pip_pkgs.extend(d["pip"])
        else:
            raise ValueError(
                f"unsupported conda dependency entry: {d!r}")
    cmds = [[conda_exe, "create", "--yes", "--quiet", "--prefix", dest,
             *conda_pkgs]]
    if pip_pkgs:
        cmds.append([conda_exe, "run", "--prefix", dest, "python", "-m",
                     "pip", "install", "--no-input", *pip_pkgs])
    return cmds


def ensure_conda_env(conda_field, *, runner=None) -> str:
    """Resolve a conda field to a site-packages path. A NAME resolves
    against `conda env list`; a SPEC dict creates a cached env keyed by
    content. Fails fast (RuntimeError) when no conda binary exists —
    the raylet's bad-env registry turns that into RuntimeEnvSetupError
    for every queued task instead of a spawn/crash loop."""
    import fcntl
    import glob as _glob
    import subprocess

    runner = runner or (lambda cmd: subprocess.run(
        cmd, check=True, capture_output=True, text=True, timeout=1800))
    conda_exe = _find_conda()
    if conda_exe is None:
        raise RuntimeError(
            "runtime_env.conda requested but no conda/mamba binary is "
            "on PATH (and CONDA_EXE is unset)")
    if isinstance(conda_field, str):
        root = os.path.dirname(os.path.dirname(conda_exe))
        if conda_field == "base":
            # base lives at the ROOT prefix, not under envs/
            base = root
        elif os.sep in conda_field:
            # `conda create -p /path/env` style: the name IS the prefix
            base = os.path.expanduser(conda_field)
        else:
            base = os.path.join(root, "envs", conda_field)
        hits = _glob.glob(os.path.join(base, "lib", "python*",
                                       "site-packages"))
        if not hits:
            raise RuntimeError(
                f"conda env {conda_field!r} not found under {base}")
        return hits[0]
    digest = hashlib.sha256(
        json.dumps(conda_field, sort_keys=True).encode()).hexdigest()[:16]
    dest = os.path.join(_cache_root(), "conda", digest)
    ready = os.path.join(dest, ".ray_tpu_ready")
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if not os.path.exists(ready):
        with open(dest + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(ready):
                try:
                    for cmd in conda_create_commands(conda_field, dest,
                                                     conda_exe):
                        runner(cmd)
                except subprocess.CalledProcessError as e:
                    shutil.rmtree(dest, ignore_errors=True)
                    raise RuntimeError(
                        f"conda env create failed: "
                        f"{e.stderr[-2000:] if e.stderr else e}") from None
                open(ready, "w").close()
    hits = _glob.glob(os.path.join(dest, "lib", "python*",
                                   "site-packages"))
    if not hits:
        raise RuntimeError(f"no site-packages under conda env {dest}")
    return hits[0]


# ---------------------------------------------------------------------------
# container plugin (reference: _private/runtime_env/container.py — the
# worker process runs inside the image)
# ---------------------------------------------------------------------------

def find_container_runtime() -> str | None:
    return shutil.which("docker") or shutil.which("podman")


def container_command(container: dict, base_cmd: list,
                      env: dict, *, runtime: str,
                      mounts: list | None = None) -> list:
    """Wrap a worker command line to run inside ``container['image']``
    (pure — unit-testable without docker installed). Host networking
    keeps the raylet/GCS ports reachable; host IPC keeps the /dev/shm
    object store attachable; the package root mounts read-only so the
    image needs python and torch but not ray_tpu_torch. A card reaches
    the container through ``run_options`` (``--gpus=all``)."""
    import ray_tpu_torch as _pkg

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        _pkg.__file__)))
    cmd = [runtime, "run", "--rm", "--network=host", "--ipc=host",
           f"-v={pkg_root}:{pkg_root}:ro"]
    for m in mounts or []:
        cmd.append(f"-v={m}:{m}")
    for k, v in env.items():
        if k.startswith(("RAY_TPU_", "CUDA_", "PYTHON")):
            cmd.append(f"-e={k}={v}")
    cmd.append(f"-e=PYTHONPATH={pkg_root}")
    cmd += container.get("run_options", [])
    cmd.append(container["image"])
    return cmd + base_cmd


def apply_runtime_env(runtime_env: dict | None) -> None:
    """Apply an env in-place to THIS process (worker boot path —
    reference: runtime-env agent's GetOrCreateRuntimeEnv result applied
    as the worker's startup context)."""
    import uuid

    if not runtime_env:
        return
    for k, v in (runtime_env.get("env_vars") or {}).items():
        os.environ[k] = v
    reqs = runtime_env.get("pip")
    if reqs:
        import sys

        site = ensure_pip_env(list(reqs))
        if site not in sys.path:
            # FRONT of sys.path: the env's packages shadow same-named
            # system packages, venv-activation style
            sys.path.insert(0, site)
    conda_field = runtime_env.get("conda")
    if conda_field:
        import sys

        site = ensure_conda_env(conda_field)
        if site not in sys.path:
            sys.path.insert(0, site)
    wd = runtime_env.get("working_dir")
    if wd:
        snap = snapshot_dir(wd)
        # Per-worker COPY of the snapshot: the worker may write to its
        # cwd, and writes must not mutate the shared content-addressed
        # cache entry (reference: per-job working_dir copies).
        workdir = os.path.join(
            _cache_root(), f"work-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        shutil.copytree(snap, workdir)
        os.chdir(workdir)
        import sys

        if workdir not in sys.path:
            sys.path.insert(0, workdir)
    for mod in runtime_env.get("py_modules") or []:
        _add_module_path(mod)


_applied_path_keys: set[str] = set()


def apply_paths(runtime_env: dict | None) -> None:
    """sys.path half of apply_runtime_env: safe for the in-process local
    runtime too (additive and idempotent — no chdir, no env mutation,
    which would be process-global and racy across worker threads).
    Memoized per env key: re-hashing/copying the working_dir tree on
    every task execution would put a full directory read on the task hot
    path."""
    import sys

    if not runtime_env:
        return
    key = env_key(runtime_env)
    if key in _applied_path_keys:
        return   # memo covers pip too (the key hashes every field)
    reqs = runtime_env.get("pip")
    if reqs:
        site = ensure_pip_env(list(reqs))
        if site not in sys.path:
            sys.path.insert(0, site)
    wd = runtime_env.get("working_dir")
    if wd:
        snap = snapshot_dir(wd)
        if snap not in sys.path:
            sys.path.insert(0, snap)
    for mod in runtime_env.get("py_modules") or []:
        _add_module_path(mod)
    _applied_path_keys.add(key)


def _add_module_path(mod: str) -> None:
    import sys

    if os.path.isdir(mod):
        snap = snapshot_dir(mod)
        # a module dir's PARENT goes on sys.path so `import <name>`
        # resolves; cached copy keeps the original name via a child
        parent = os.path.join(_cache_root(),
                              "mods-" + _dir_content_hash(mod))
        target = os.path.join(parent, os.path.basename(mod))
        if not os.path.isdir(target):
            os.makedirs(parent, exist_ok=True)
            shutil.copytree(snap, target, dirs_exist_ok=True)
        if parent not in sys.path:
            sys.path.insert(0, parent)
    else:
        d = os.path.dirname(mod)
        if d not in sys.path:
            sys.path.insert(0, d)
