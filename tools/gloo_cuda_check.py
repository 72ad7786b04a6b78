"""Which gloo collectives take CUDA tensors, for two ranks on one card?

    python3 tools/gloo_cuda_check.py

NCCL refuses two ranks on one device, so the port's multi-rank runs on a
one-card machine (``chip_smoke.py``'s ``sharded`` phase) use gloo, which
stages CUDA tensors through the host. This spawns two gloo ranks on
``cuda:0`` (a ``FileStore`` in a temporary directory) and tries
``all_reduce``, ``all_to_all_single``, ``all_gather`` and ``broadcast``
on f32, bf16 and int8 tensors ("ok" or the exception), then times one
``all_reduce`` and one ``all_gather`` of 192 MB of f32 on the host clock
(synchronised, after a warm-up call). One JSON line from rank 0. Needs a
card.
"""

from __future__ import annotations

import json
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MB = 192


def run(rank: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    dev = torch.device("cuda:0")
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        ops = {
            "all_reduce": lambda: dist.all_reduce(
                torch.full((5,), rank + 1, dtype=dt, device=dev)),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty(4, dtype=dt, device=dev),
                (torch.arange(4, device=dev) + 10 * rank).to(dt)),
            "all_gather": lambda: dist.all_gather(
                [torch.empty(3, dtype=dt, device=dev) for _ in range(2)],
                torch.full((3,), rank, dtype=dt, device=dev)),
            "broadcast": lambda: dist.broadcast(
                torch.full((3,), rank, dtype=dt, device=dev), 0),
        }
        for name, op in ops.items():
            try:
                op()
                torch.cuda.synchronize()
                out[f"{name}_{str(dt)[6:]}"] = "ok"
            except Exception as e:   # the finding is whether it raises
                out[f"{name}_{str(dt)[6:]}"] = repr(e)[:200]
    x = torch.randn(MB * 2**20 // 4, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(x)
    torch.cuda.synchronize()
    out[f"all_reduce_{MB}MB_s"] = time.perf_counter() - t0
    parts = [torch.empty_like(x) for _ in range(2)]
    t0 = time.perf_counter()
    dist.all_gather(parts, x)
    torch.cuda.synchronize()
    out[f"all_gather_{MB}MB_s"] = time.perf_counter() - t0
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(f"{tmp}/store",), nprocs=2)
