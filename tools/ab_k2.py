"""Time K2 (the head backward's dH kernel) of one or more checkouts of the
PyTorch port on one CUDA card, each checkout in a process of its own.

    python3 tools/ab_k2.py ROOT [ROOT ...]

Each ROOT is a checkout whose ``src/`` holds ``repro_torch``; a root may
be named more than once, so that ``A B B A`` interleaves two versions
within one session on one card. Every process builds its checkout's
kernels and times ``sparton_backward_dh`` with CUDA events (WINDOWS
windows of REPS launches after a warm-up; the median window is reported
beside the spread) at the train step's shape (384 x 256, bf16 hidden
states padded as the step pads them) and at the paper's Table-1 shape
(320 x 512, unpadded), on the same seeded inputs: the head weights of
``configs/splade_bert.CONFIG`` from seed 0, as ``chip_smoke.py`` makes
them. It prints one JSON line per root and shape, with a SHA-256 of the
result's bytes, so that equal hashes show two versions give the same
bits, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

WINDOWS = 5
REPS = 10
SHAPES = {"train": ("table3_384", True), "table1": ("table1", False)}


def child(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.configs.splade_bert import CONFIG, SHAPES as CFG_SHAPES
    from repro_torch.kernels.sparton import sparton_forward
    from repro_torch.kernels.sparton_bwd import sparton_backward_dh
    from repro_torch.models.transformer import head_weights, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         CONFIG)
    E, b = head_weights(params, CONFIG)
    E = E.to(torch.bfloat16)
    del params
    for name, (shape, padded) in SHAPES.items():
        spec = CFG_SHAPES[shape]
        B, S = spec.global_batch, spec.seq_len
        g = torch.Generator(device="cuda").manual_seed(12)
        H = torch.randn((B, S, CONFIG.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
        if padded:
            lens = torch.randint(int(0.3 * S), S + 1, (B, 1), generator=g,
                                 device="cuda")
            mask = (torch.arange(S, device="cuda") < lens).int()
        else:
            mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
        y, i_max = sparton_forward(H, E, b, mask)
        dy = torch.randn(y.shape, generator=g, device="cuda") * 1e-2
        del H

        def run():
            return sparton_backward_dh(dy, y, i_max, E, S)

        for _ in range(2):
            dh = run()
        torch.cuda.synchronize()
        times = []
        for _ in range(WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / REPS)
        digest = hashlib.sha256(dh.cpu().numpy().tobytes()).hexdigest()[:16]
        print(json.dumps({"root": str(root), "shape": name, "B": B, "S": S,
                          "ms": sorted(times)[WINDOWS // 2],
                          "ms_range": [min(times), max(times)],
                          "dh_sha256": digest}), flush=True)
        del dh, dy, y, i_max
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve())
        return 0
    if not args.roots:
        ap.error("name at least one checkout")
    rc = 0
    for root in args.roots:
        rc |= subprocess.run([sys.executable, __file__, "--child",
                              str(root)]).returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
