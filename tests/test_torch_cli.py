"""The port's CLI (``ray_tpu_torch/scripts/cli.py``) against the JAX package's.

The ported subcommands (``start``, ``status``, ``list``, ``submit``,
``serve-deploy``, ``serve-status``) have the same argparse tree as JAX's,
``--num-gpus`` in place of ``--num-tpus``. Then each package's
``start --head`` runs as a subprocess on a free port, and ``status``,
``list nodes``, ``submit`` and ``serve-deploy`` of a JSON config print
the same lines (addresses, ids and store names aside). The port's
``serve-status`` in another process then reads the deployment (both
serve subcommands attach in the namespace ``serve``; JAX's attach in
fresh anonymous namespaces, where its ``serve-status`` finds none), and a
SIGTERM stops the port's node with its workers.
"""

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

from ray_tpu.scripts import cli as jcli
from ray_tpu_torch.scripts import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
PORTED = ("start", "status", "list", "submit", "serve-deploy",
          "serve-status")
CLI = {"jax": "ray_tpu.scripts.cli", "torch": "ray_tpu_torch.scripts.cli"}
TARGET = {"jax": "tests._serve_config_target",
          "torch": "torch_serve_targets"}


class _Parsed(Exception):
    pass


def _tree(cli_mod, monkeypatch) -> dict:
    """{subcommand: [(option strings, dest, default, type, choices,
    required, nargs)]} of the CLI's parser."""
    seen = {}

    def capture(self, argv=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        cli_mod.main([])
    monkeypatch.undo()
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, parser in sub.choices.items():
        out[name] = [
            (tuple(a.option_strings), a.dest, a.default,
             getattr(a.type, "__name__", a.type),
             tuple(a.choices) if a.choices else None, a.required, a.nargs)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)]
    return out


def test_argparse_tree_matches_jax(monkeypatch):
    jtree = _tree(jcli, monkeypatch)
    ttree = _tree(tcli, monkeypatch)
    assert sorted(ttree) == sorted(PORTED)
    for name in PORTED:
        # JAX's --num-tpus is the port's --num-gpus
        want = [(tuple(o.replace("tpus", "gpus") for o in a[0]),
                 a[1].replace("tpus", "gpus")) + a[2:] for a in jtree[name]]
        assert ttree[name] == want, name
    assert ("--num-gpus",) in [a[0] for a in ttree["start"]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_FAULT")}
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS])
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(pkg, *args, timeout=120):
    out = subprocess.run([sys.executable, "-m", CLI[pkg], *args],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _normalize(text: str) -> str:
    text = re.sub(r"127\.0\.0\.1:\d+", "HOST:PORT", text)
    text = re.sub(r"\[\s*\"127\.0\.0\.1\",\s*\d+\s*\]", "ADDR", text)
    text = re.sub(r"\b[0-9a-f]{12,32}\b", "ID", text)
    text = re.sub(r"/(raytpu|rtt)_\d+_[0-9a-f]+", "/STORE", text)
    return text


@pytest.fixture(scope="module")
def heads():
    """``start --head`` of each package, as a user runs it."""
    procs, out = {}, {}
    try:
        for pkg in ("jax", "torch"):
            port = _free_port()
            p = subprocess.Popen(
                [sys.executable, "-m", CLI[pkg], "start", "--head",
                 "--port", str(port), "--num-cpus", "2"],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, text=True)
            procs[pkg] = p
            lines = [p.stdout.readline() for _ in range(3)]
            out[pkg] = (f"127.0.0.1:{port}", lines, p)
        yield out
    finally:
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        for pkg, p in procs.items():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_start_status_list_submit_print_the_same(heads, tmp_path):
    lines = {pkg: _normalize("".join(v[1])) for pkg, v in heads.items()}
    assert lines["torch"] == lines["jax"].replace(
        "ray_tpu.init", "ray_tpu_torch.init")
    status = {pkg: _normalize(_run(pkg, "status", "--address", addr))
              for pkg, (addr, _, _) in heads.items()}
    assert status["torch"] == status["jax"]
    assert status["torch"].startswith("Nodes: 1 alive / 1 total\n")
    nodes = {pkg: json.loads(_run(pkg, "list", "nodes", "--address", addr))
             for pkg, (addr, _, _) in heads.items()}
    keys = {pkg: sorted(set(n[0]) - {"agent_addr"}) for pkg, n in
            nodes.items()}
    assert keys["torch"] == keys["jax"]
    assert nodes["torch"][0]["labels"] == {"head": True}
    assert nodes["torch"][0]["resources"] == nodes["jax"][0]["resources"]
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys\n"
        "print(sys.argv[1:], bool(os.environ.get('RAY_TPU_TORCH_ADDRESS')"
        " or os.environ.get('RAY_TPU_ADDRESS')))\n")
    subs = {pkg: _run(pkg, "submit", "--address", addr, str(script), "a",
                      "b") for pkg, (addr, _, _) in heads.items()}
    assert subs["torch"] == subs["jax"] == "['a', 'b'] True\n"


def test_serve_deploy_json_and_serve_status(heads, tmp_path):
    deployed = {}
    for pkg, (addr, _, _) in heads.items():
        cfg = tmp_path / f"{pkg}.json"
        cfg.write_text(json.dumps({"deployments": [
            {"import_path": f"{TARGET[pkg]}:greeter",
             "init_args": ["hey"], "num_replicas": 1}]}))
        deployed[pkg] = _run(pkg, "serve-deploy", str(cfg), "--address",
                             addr)
    assert deployed["torch"] == deployed["jax"] == "deployed Greeter\n"
    status = json.loads(_run("torch", "serve-status", "--address",
                             heads["torch"][0]))
    greeter = status["deployments"]["Greeter"]
    assert greeter["target"] == 1 and greeter["running"] == 1
    assert greeter["total_requests"] == 0


def test_sigterm_stops_the_node_and_its_workers(heads):
    """After ``serve-deploy`` the port's node runs worker processes (the
    controller and a replica); a SIGTERM to ``start`` takes them down."""
    _, _, proc = heads["torch"]
    workers = _node_workers(proc.pid)
    assert workers
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        alive = [pid for pid in workers if _alive(pid)]
        if not alive:
            break
        time.sleep(0.1)
    assert not alive


def _stat(pid) -> list:
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rpartition(")")[2].split()


def _alive(pid: int) -> bool:
    try:
        return _stat(pid)[0] != "Z"
    except OSError:
        return False


def _node_workers(parent_pid: int) -> list:
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
            stat = _stat(pid)
        except OSError:
            continue
        if (b"ray_tpu_torch.runtime.worker_main" in cmd
                and stat[0] != "Z" and int(stat[1]) == parent_pid):
            out.append(int(pid))
    return out
