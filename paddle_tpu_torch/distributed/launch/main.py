"""Launch controller, collective mode (``paddle_tpu/distributed/launch/
main.py`` analog).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py [args...]

starts ``--nproc_per_node`` workers of ``train.py`` on this host. Worker
``i`` of host ``--rank`` r is global rank ``r * nproc_per_node + i`` and
gets ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``
(``--master`` when given, else a file store in a fresh temporary
directory: no port to pick) and ``FLAGS_selected_gpus`` (its local rank
modulo the visible cards; unset without a card). Each worker's output goes
to ``<log_dir>/workerlog.<i>``. When a worker fails, the others are
stopped (a rank left waiting in a collective would wait forever) and the
launcher exits with the first failure's code; it prints every worker's
code.

Parameter-server mode (``--run_mode ps``, ``--server_num``, ...) is ROADMAP
queue A item A8; elastic restarts (``--max_restart``, an ``--nnodes``
range) are A5.8.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.distributed.launch")
    p.add_argument("--nnodes", type=str, default="1",
                   help="number of hosts")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this host, one per rank")
    p.add_argument("--master", type=str, default=None,
                   help="where the ranks meet: host:port or file:///path "
                   "(default: a file store in a temporary directory, one "
                   "host only)")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_TRAINER_ID", 0)),
                   help="this host's index")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--devices", "--gpus", type=str, default=None,
                   help="visible device ids (CUDA_VISIBLE_DEVICES)")
    p.add_argument("--max_restart", type=int, default=0,
                   help="elastic restarts (not ported: ROADMAP A5.8)")
    p.add_argument("--run_mode", type=str, default=None,
                   help="collective (default); ps is not ported")
    p.add_argument("--server_num", type=int, default=None)
    p.add_argument("--trainer_num", type=int, default=None)
    p.add_argument("--servers", type=str, default="")
    p.add_argument("--trainers", type=str, default="")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _ps_mode(args) -> bool:
    return bool(args.run_mode == "ps" or args.server_num or args.servers
                or args.trainer_num or args.trainers)


def _pkg_pythonpath(env: dict):
    """Children import paddle_tpu_torch even when it is not installed: the
    package's parent directory goes first on PYTHONPATH."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _visible_cards(args) -> int:
    if args.devices is not None:
        return len([d for d in args.devices.split(",") if d])
    import torch

    return torch.cuda.device_count()


def _worker_env(args, local_rank: int, world: int) -> dict:
    env = _pkg_pythonpath(dict(os.environ))
    rank = args.rank * args.nproc_per_node + local_rank
    env.update(
        PADDLE_TRAINER_ID=str(rank),
        PADDLE_TRAINERS_NUM=str(world),
        PADDLE_JOB_ID=args.job_id,
    )
    if args.master:
        env["PADDLE_MASTER"] = args.master
        env["MASTER_ADDR"] = args.master
    if args.devices:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    cards = _visible_cards(args)
    if cards:
        env["FLAGS_selected_gpus"] = str(local_rank % cards)
    return env


def _stop(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.terminate()
    for p, _ in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(args=None) -> int:
    args = args if args is not None else _parse_args()
    if _ps_mode(args):
        raise NotImplementedError("the launcher's parameter-server mode is "
                                  "not ported yet (ROADMAP queue A item A8)")
    if args.max_restart or ":" in str(args.nnodes):
        raise NotImplementedError("elastic restarts and --nnodes ranges are "
                                  "not ported yet (ROADMAP queue A item "
                                  "A5.8)")
    nnodes = int(args.nnodes)
    store_dir = None
    if not args.master:
        if nnodes > 1:
            raise ValueError("--nnodes above 1 needs --master host:port")
        store_dir = tempfile.mkdtemp(prefix="paddle_launch_")
        args.master = f"file://{os.path.join(store_dir, 'store')}"
    os.makedirs(args.log_dir, exist_ok=True)
    world = nnodes * args.nproc_per_node
    cmd = [sys.executable, args.training_script, *args.training_script_args]
    procs, first = [], None
    try:
        for lr in range(args.nproc_per_node):
            log = open(os.path.join(args.log_dir, f"workerlog.{lr}"), "w")
            procs.append((subprocess.Popen(
                cmd, env=_worker_env(args, lr, world), stdout=log,
                stderr=subprocess.STDOUT), log))
        # watch the workers: the first failure stops the rest
        while first is None and any(p.poll() is None for p, _ in procs):
            time.sleep(0.05)
            first = next((p.returncode for p, _ in procs
                          if p.poll() not in (None, 0)), None)
        first = next((p.returncode for p, _ in procs
                      if p.poll() not in (None, 0)), first)
    finally:
        _stop(procs)
        for _, log in procs:
            log.close()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
    codes = [p.returncode for p, _ in procs]
    print(f"launch: worker exit codes {codes} (logs in {args.log_dir})",
          file=sys.stderr, flush=True)
    if first is None:
        return 0
    # a signal's death is negative; the launcher's exit is a failure
    return first if first > 0 else 1


def main():
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    sys.exit(launch())


if __name__ == "__main__":
    main()
