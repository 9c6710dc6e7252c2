"""Launcher CLI (port of ``deepspeed_tpu/launcher/runner.py``, reference
``launcher/runner.py:377`` and ``launch.py:216``)::

    python -m deepspeed_tpu_torch.launcher.runner --num_gpus N script.py args…

JAX drives every chip of a host from one process, so its launcher starts
one process per host.  PyTorch runs one process per GPU, so on one host
this launcher starts ``N`` copies of the script (default: every visible
GPU), each with the environment that ``comm.init_distributed`` reads —
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` — as the reference's ``launch.py`` sets
it.  On the CPU ``--num_gpus`` counts processes (each joins a gloo group).

The hostfile (``<host> slots=<n>`` lines) and ``--include`` /
``--exclude`` are parsed as in JAX; a pool of more than one host, and the
ssh / pdsh / MPI / SLURM runners, raise ``NotImplementedError``
(ROADMAP.md, queue A).  A child that exits non-zero ends the others
(SIGTERM, then SIGKILL after ``KILL_GRACE_S`` seconds) and its code is
the launcher's; SIGINT / SIGTERM to the launcher go to every child.
"""

import argparse
import base64
import json
import os
import signal
import subprocess
import sys
import time

from deepspeed_tpu_torch.utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"
# seconds between SIGTERM and SIGKILL of the other ranks when one fails
KILL_GRACE_S = 10.0
MULTI_NODE_LAUNCHERS = ("ssh", "pdsh", "openmpi", "mpich", "slurm",
                        "mvapich")


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch launcher",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="Hostfile: lines of '<host> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="Include filter, e.g. 'host1@host2'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="Exclude filter")
    parser.add_argument("--num_nodes", type=int, default=-1)
    parser.add_argument("--num_gpus", "--num_chips", type=int, default=-1,
                        dest="num_gpus",
                        help="processes to start (default: visible GPUs)")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--master_addr", type=str, default="")
    parser.add_argument("--launcher", type=str, default="local",
                        choices=["local"] + list(MULTI_NODE_LAUNCHERS))
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path):
    """Parse '<host> slots=<n>' lines (reference ``runner.py:189``)."""
    if not os.path.isfile(hostfile_path):
        return {}
    resource_pool = {}
    with open(hostfile_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            host = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=")[1])
            if host in resource_pool:
                raise ValueError(f"host {host} repeated in hostfile")
            resource_pool[host] = slots
    return resource_pool


def _filter_hosts(resource_pool, include_str, exclude_str):
    """--include/--exclude host filters (reference ``runner.py:244``)."""
    hosts = dict(resource_pool)
    if include_str:
        keep = set(include_str.split("@"))
        hosts = {h: s for h, s in hosts.items() if h in keep}
    if exclude_str:
        drop = set(exclude_str.split("@"))
        hosts = {h: s for h, s in hosts.items() if h not in drop}
    return hosts


def encode_world_info(resource_pool):
    """b64 world info (reference ``runner.py:342``)."""
    data = json.dumps(resource_pool).encode()
    return base64.urlsafe_b64encode(data).decode()


def decode_world_info(encoded):
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


def _visible_gpus():
    try:
        import torch
        return torch.cuda.device_count()
    except ImportError:
        return 0


def rank_env(base, rank, world, master_addr, master_port):
    """The environment of local rank ``rank`` of ``world`` on one host."""
    env = dict(base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR=master_addr,
               MASTER_PORT=str(master_port))
    return env


def _stop(procs, grace):
    """SIGTERM every live child, then SIGKILL whatever outlives
    ``grace`` seconds; reap them all."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        left = deadline - time.monotonic()
        try:
            p.wait(timeout=max(left, 0.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_local(cmd, world, master_addr, master_port):
    """Start ``world`` copies of ``cmd`` (one a GPU) and wait: 0 when all
    exit 0; else the first non-zero exit code seen, after the others were
    stopped."""
    procs = [subprocess.Popen(cmd, env=rank_env(os.environ, r, world,
                                                master_addr, master_port))
             for r in range(world)]

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = {s: signal.signal(s, forward) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                rank, code = failed[0]
                logger.error(f"rank {rank} exited with code {code}: stopping "
                             f"the other ranks")
                _stop(procs, KILL_GRACE_S)
                return code
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def main(args=None):
    args = parse_args(args)
    resource_pool = fetch_hostfile(args.hostfile)
    resource_pool = _filter_hosts(resource_pool, args.include, args.exclude)
    if args.num_nodes > 0:
        resource_pool = dict(list(resource_pool.items())[:args.num_nodes])
    remote = [h for h in resource_pool if h not in ("localhost",
                                                    "127.0.0.1")]
    if len(resource_pool) > 1 or remote or \
            args.launcher in MULTI_NODE_LAUNCHERS:
        raise NotImplementedError(
            f"multi-node launch (hosts {sorted(resource_pool)}, launcher "
            f"{args.launcher!r}) is not ported to deepspeed_tpu_torch yet: "
            f"the ssh / pdsh / MPI / SLURM runners wait (see ROADMAP.md, "
            f"queue A); run on one host")
    world = args.num_gpus
    if world <= 0:
        world = sum(resource_pool.values()) if resource_pool \
            else _visible_gpus()
    if world <= 0:
        raise RuntimeError("no GPU is visible: pass --num_gpus N (on the "
                           "CPU, N gloo processes)")
    cmd = [sys.executable, "-u", args.user_script] + args.user_args
    master = args.master_addr or "127.0.0.1"
    logger.info(f"launching {world} rank(s) on this host: {' '.join(cmd)} "
                f"(master {master}:{args.master_port})")
    return launch_local(cmd, world, master, args.master_port)


if __name__ == "__main__":
    sys.exit(main())
