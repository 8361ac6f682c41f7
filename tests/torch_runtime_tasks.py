"""Task bodies of the port's prestart, runtime-env and chaos tests.

The port carries a task by stdlib pickle, by reference, so its workers
import this module; it imports nothing of ``ray_tpu`` or torch at module
level, so a worker (cold or forked) stays quick.
"""

import importlib
import os


def fork_probe():
    """Where this worker came from, and what it inherited."""
    from ray_tpu_torch.runtime import fault_injection as fi
    from ray_tpu_torch.runtime import prestart

    return {
        "pid": os.getpid(),
        "child_info": prestart.CHILD_INFO,
        "zygote_fd_env": prestart.ZYGOTE_FD_ENV in os.environ,
        "plane_active": fi.plane.active,
        "plane_rules": len(fi.plane._rules),
    }


def env_probe(var=None, module=None):
    """This worker's view of its runtime env: an env var, its cwd and a
    file there, and a module imported by name."""
    out = {"var": os.environ.get(var) if var else None,
           "cwd_files": sorted(os.listdir(os.getcwd()))[:8]}
    if module:
        mod = importlib.import_module(module)
        out["module"] = getattr(mod, "VALUE", None)
        out["module_file_in_cache"] = ".ray_tpu" in (mod.__file__ or "") \
            or "runtime_env" in (mod.__file__ or "")
    try:
        from ray_tpu_torch.runtime import prestart
        out["forked_from"] = (prestart.CHILD_INFO or {}).get("template_pid")
    except ImportError:
        out["forked_from"] = None
    return out


def double(x):
    return x * 2


class Echo:
    def __call__(self, x):
        return x
