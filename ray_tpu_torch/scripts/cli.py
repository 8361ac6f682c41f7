"""ray-tpu-torch CLI (reference: ``python/ray/scripts/scripts.py`` —
start/stop/status/… and the state CLI ``util/state/state_cli.py``).

Port of ``ray_tpu/scripts/cli.py``: the same argparse tree and printed
lines for ``start`` (``--num-gpus`` for JAX's ``--num-tpus``), ``status``,
``list``, ``submit``, ``serve-deploy`` and ``serve-status``. ``start``
also stops its raylet and GCS on SIGTERM, so the node's workers and
templates go with it. ``submit`` hands the script its cluster in
``RAY_TPU_TORCH_ADDRESS``. ``serve-deploy`` and ``serve-status`` attach
in the namespace ``serve`` (``SERVE_NAMESPACE``), where Serve's
detached controller is found by name: what one deploys the other reads,
and a driver that attaches with ``namespace="serve"`` gets its handles.
(JAX's attach in fresh anonymous namespaces, so its ``serve-status`` in
another process finds no controller.) The subcommands over planes the port does not
have yet (``memory``, ``summary``, ``dashboard``, ``timeline``,
``debug``) are left for their slices.

Run it as ``python -m ray_tpu_torch.scripts.cli`` (or the
``ray-tpu-torch`` console script)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# the namespace the serve subcommands attach in: Serve's controller is a
# detached named actor, found by name within one namespace
SERVE_NAMESPACE = "serve"


def cmd_start(args):
    """Start a head node (GCS + raylet) or join an existing cluster."""
    import signal

    from ray_tpu_torch.runtime.gcs import GcsServer
    from ray_tpu_torch.runtime.raylet import Raylet
    from ray_tpu_torch.utils.ids import NodeID

    resources = {"CPU": float(args.num_cpus)}
    if args.num_gpus:
        resources["GPU"] = float(args.num_gpus)
    gcs = None
    if args.head:
        gcs = GcsServer(host=args.host, port=args.port).start()
        print(f"GCS listening on {gcs.address[0]}:{gcs.address[1]}")
        gcs_address = gcs.address
        labels = {"head": True}
    else:
        if not args.address:
            sys.exit("--address required for non-head nodes")
        host, _, port = args.address.rpartition(":")
        gcs_address = (host, int(port))
        labels = {}
    raylet = Raylet(
        node_id=NodeID.from_random().hex(), gcs_address=gcs_address,
        resources=resources,
        store_capacity=args.object_store_memory, labels=labels).start()
    print(f"raylet on {raylet.address[0]}:{raylet.address[1]} "
          f"(store {raylet.store_name})")
    print(f"connect with: ray_tpu_torch.init(address="
          f"'{gcs_address[0]}:{gcs_address[1]}')", flush=True)

    def _interrupt(*_):
        raise KeyboardInterrupt

    # SIGTERM stops the node as Ctrl-C does: the raylet takes its
    # workers and fork-server templates down with it
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        raylet.stop()
        if gcs is not None:
            gcs.stop()


def _gcs_client(args):
    from ray_tpu_torch.runtime.rpc import RpcClient

    host, _, port = args.address.rpartition(":")
    return RpcClient((host or "127.0.0.1", int(port)))


def cmd_status(args):
    client = _gcs_client(args)
    nodes = client.call("get_nodes", alive_only=False)
    res = client.call("cluster_resources")
    print(f"Nodes: {sum(1 for n in nodes if n['alive'])} alive / "
          f"{len(nodes)} total")
    print(f"Resources: {json.dumps(res['available'])} available of "
          f"{json.dumps(res['total'])}")
    for n in nodes:
        mark = "+" if n["alive"] else "-"
        print(f"  [{mark}] {n['node_id'][:12]} @ "
              f"{n['address'][0]}:{n['address'][1]} {n['resources']}")


def cmd_list(args):
    client = _gcs_client(args)
    method = {"nodes": "get_nodes", "actors": "list_actors",
              "jobs": "list_jobs", "pgs": "list_placement_groups",
              "tasks": "get_task_events"}[args.resource]
    rows = client.call(method)
    print(json.dumps(rows, indent=2, default=str))


def cmd_submit(args):
    """Run a driver script against a cluster (reference: job submit)."""
    import subprocess

    env = dict(os.environ)
    env["RAY_TPU_TORCH_ADDRESS"] = args.address
    sys.exit(subprocess.call([sys.executable, args.script] + args.args,
                             env=env))


def cmd_serve_deploy(args):
    """Apply a declarative serve config (reference: ``serve deploy``)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.schema import apply_config_file

    if args.address:
        ray_tpu_torch.init(address=args.address, namespace=SERVE_NAMESPACE)
    else:
        ray_tpu_torch.init(num_cpus=args.num_cpus, namespace=SERVE_NAMESPACE)
    handles = apply_config_file(args.config)
    for name in handles:
        print(f"deployed {name}")
    if args.block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass


def cmd_serve_status(args):
    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init(address=args.address, namespace=SERVE_NAMESPACE)
    print(json.dumps(serve.status(), indent=2, default=str))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ray-tpu-torch", description="ray_tpu_torch cluster CLI")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="GCS host:port (non-head)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6379)
    p.add_argument("--num-cpus", type=float,
                   default=float(os.cpu_count() or 1))
    p.add_argument("--num-gpus", type=float, default=0)
    p.add_argument("--object-store-memory", type=int, default=1 << 30)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("status", help="cluster status")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("resource",
                   choices=["nodes", "actors", "jobs", "pgs", "tasks"])
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("submit", help="run a script against the cluster")
    p.add_argument("--address", required=True)
    p.add_argument("script")
    p.add_argument("args", nargs="*")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("serve-deploy",
                       help="apply a declarative serve config (JSON or YAML)")
    p.add_argument("config")
    p.add_argument("--address", help="GCS host:port (omit for local)")
    p.add_argument("--num-cpus", type=float,
                   default=float(os.cpu_count() or 1))
    p.add_argument("--block", action="store_true",
                   help="keep the process (and local cluster) alive")
    p.set_defaults(fn=cmd_serve_deploy)

    p = sub.add_parser("serve-status", help="serve deployment status")
    p.add_argument("--address", required=True)
    p.set_defaults(fn=cmd_serve_status)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
