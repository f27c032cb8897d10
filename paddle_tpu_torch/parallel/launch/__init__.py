"""Process entry points of the port (counterpart of
paddle_tpu/parallel/launch).

Ported so far: `serve_worker`, the decode fleet's subprocess worker
(``python -m paddle_tpu_torch.parallel.launch.serve_worker``). The gang
launcher and supervisor (`gang.py`, `main.py`) come with the rest of
`resilience/` (ROADMAP.md section 1 item 4).
"""
