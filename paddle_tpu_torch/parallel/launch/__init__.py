"""Process entry points of the port (counterpart of
paddle_tpu/parallel/launch).

- `gang`: `GangSupervisor` spawns, watches and relaunches a
  checkpoint-coordinated worker gang (``python -m
  paddle_tpu_torch.parallel.launch.gang -n N -- CMD ...``);
- `serve_worker`: the decode fleet's subprocess worker (``python -m
  paddle_tpu_torch.parallel.launch.serve_worker``);
- `main`: the rank launcher, the ``paddle.distributed.launch`` twin
  (``python -m paddle_tpu_torch.parallel.launch --nproc_per_node N
  script.py``): it starts the ranks of a torch.distributed job with the
  rendezvous in their environment, such as the ranks of a
  ``serving_mp`` / ``serving_cp`` engine. Its elastic mode is not here
  (ROADMAP.md section 1 item 5).
"""
import importlib

__all__ = ["GangResult", "GangSupervisor", "launch", "serve_worker"]


def __getattr__(name):
    # resolved on first use, so ``python -m`` of either module does not
    # find it imported already by its package
    if name in ("GangResult", "GangSupervisor"):
        return getattr(importlib.import_module(".gang", __name__), name)
    if name == "serve_worker":
        return importlib.import_module(".serve_worker", __name__)
    if name == "launch":
        return importlib.import_module(".main", __name__).launch
    raise AttributeError(name)
