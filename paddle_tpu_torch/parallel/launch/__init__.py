"""Process entry points of the port (counterpart of
paddle_tpu/parallel/launch).

- `gang`: `GangSupervisor` spawns, watches and relaunches a
  checkpoint-coordinated worker gang (``python -m
  paddle_tpu_torch.parallel.launch.gang -n N -- CMD ...``);
- `serve_worker`: the decode fleet's subprocess worker (``python -m
  paddle_tpu_torch.parallel.launch.serve_worker``).

The JAX package's `launch` (``main.py``, the ``paddle.distributed.launch``
twin) exports a JAX rendezvous; its port exports the torch.distributed
one and comes with multi-GPU training (ROADMAP.md section 1 item 5).
"""
import importlib

__all__ = ["GangResult", "GangSupervisor", "serve_worker"]


def __getattr__(name):
    # resolved on first use, so ``python -m`` of either module does not
    # find it imported already by its package
    if name in ("GangResult", "GangSupervisor"):
        return getattr(importlib.import_module(".gang", __name__), name)
    if name == "serve_worker":
        return importlib.import_module(".serve_worker", __name__)
    raise AttributeError(name)
