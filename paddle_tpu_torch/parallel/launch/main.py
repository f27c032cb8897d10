"""The rank launcher (counterpart of paddle_tpu/parallel/launch/main.py,
the ``paddle.distributed.launch`` twin), without its elastic mode.

    python -m paddle_tpu_torch.parallel.launch --nproc_per_node 2 \\
        [--master HOST:PORT] [--nnodes N] [--rank NODE] [--log_dir DIR] \\
        [--max_restart K] script.py [args ...]

starts `--nproc_per_node` processes of ``python script.py args`` on this
node, each with the torch.distributed rendezvous in its environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``; and Paddle's ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, ``PADDLE_LOCAL_RANK``) where
the JAX launcher exports a JAX one. The script calls
`paddle_tpu_torch.parallel.ranks.init_ranks()` to join (NCCL when every
rank has a GPU of its own, gloo otherwise). The launcher watches its
children: one that fails takes the others down, and the job restarts up
to `--max_restart` times; the exit code is 0 when every rank exits 0.
`--nnodes min:max` (elastic membership, which needs `parallel/elastic`)
raises.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.parallel.launch",
        description="torch.distributed rank launcher")
    p.add_argument("--master", default=None,
                   help="rendezvous host:port (default: 127.0.0.1 and a "
                        "free port)")
    p.add_argument("--nnodes", default="1",
                   help="number of nodes (min:max, elastic, is refused)")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", 0)),
                   help="this node's rank")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="rank processes on this node")
    p.add_argument("--log_dir", default=None,
                   help="per-rank log directory (workerlog.<local rank>)")
    p.add_argument("--max_restart", type=int, default=3,
                   help="restarts of the job before giving up")
    p.add_argument("--devices", default=None,
                   help="accepted for API parity (rank r takes "
                        "cuda:(r % device_count))")
    p.add_argument("script", help="the script every rank runs")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(base: dict, master: str, nproc: int, node_rank: int,
                local_rank: int, total: int) -> dict:
    env = dict(base)
    host, port = master.rsplit(":", 1)
    rank = node_rank * nproc + local_rank
    env.update({
        # torch.distributed's env:// rendezvous
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
        "RANK": str(rank),
        "LOCAL_RANK": str(local_rank),
        "WORLD_SIZE": str(total),
        "LOCAL_WORLD_SIZE": str(nproc),
        # Paddle's names (PaddleCloudRoleMaker's env discovery)
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(total),
        "PADDLE_MASTER": master,
        "PADDLE_LOCAL_RANK": str(local_rank),
    })
    return env


class _Supervisor:
    """Start the ranks, watch them, and on a failure stop the rest and
    restart the job up to `max_restart` times."""

    def __init__(self, cmd: List[str], envs: List[dict],
                 log_dir: Optional[str], max_restart: int):
        self.cmd = cmd
        self.envs = envs
        self.log_dir = log_dir
        self.max_restart = max_restart
        self.procs: List[subprocess.Popen] = []
        self._logs = []

    def _spawn(self):
        self.procs, self._logs = [], []
        for i, env in enumerate(self.envs):
            out = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                out = open(os.path.join(self.log_dir, f"workerlog.{i}"),
                           "ab")
                self._logs.append(out)
            self.procs.append(subprocess.Popen(self.cmd, env=env,
                                               stdout=out, stderr=out))

    def _stop_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 5
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self._logs:
            f.close()

    def run(self) -> int:
        restarts = 0
        while True:
            self._spawn()
            failed = None
            try:
                while failed is None:
                    alive = 0
                    for p in self.procs:
                        rc = p.poll()
                        if rc is None:
                            alive += 1
                        elif rc != 0:
                            failed = rc
                            break
                    if failed is None and alive == 0:
                        return 0
                    time.sleep(0.1)
            finally:
                self._stop_all()
            restarts += 1
            if restarts > self.max_restart:
                return failed
            print(f"[launch] rank failed (rc={failed}); restart "
                  f"{restarts}/{self.max_restart}", file=sys.stderr)


def launch(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    if ":" in str(args.nnodes):
        raise NotImplementedError(
            f"--nnodes {args.nnodes}: elastic membership needs "
            "parallel/elastic, which comes with dp / mp / pp training "
            "(ROADMAP.md section 1 item 5)")
    nnodes = int(args.nnodes)
    master = args.master or f"127.0.0.1:{_free_port()}"
    total = nnodes * args.nproc_per_node
    cmd = [sys.executable, args.script] + list(args.script_args)
    envs = [_worker_env(os.environ, master, args.nproc_per_node, args.rank,
                        lr, total)
            for lr in range(args.nproc_per_node)]
    return _Supervisor(cmd, envs, args.log_dir, args.max_restart).run()


if __name__ == "__main__":
    sys.exit(launch())
