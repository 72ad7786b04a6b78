"""Time K2 and K3 (the head backward's dH and dE + db kernels) of one or
more checkouts of the PyTorch port on one CUDA card, each checkout in a
process of its own.

    python3 tools/ab_bwd.py ROOT [ROOT ...]

Each ROOT is a checkout whose ``src/`` holds ``repro_torch``; a root may
be named more than once, so that ``A B B A`` interleaves two versions
within one run on one card. Every process builds its checkout's
kernels and times ``sparton_backward_dh`` and ``sparton_backward_de``
with CUDA events (``chip_smoke.cuda_ms``: its WINDOWS windows of REPS
launches after a warm-up; the median window is reported beside the
spread) on ``chip_smoke.py``'s four
K2/K3 timing rows (``BWD_ROWS``: the train step's 384 x 256, Table-1's
320 x 512, and the "sparse" and "skewed" inputs at 384 x 256), made by
this checkout's ``chip_smoke.bwd_timing_inputs`` from the head weights of
``configs/splade_bert.CONFIG`` at seed 0, as ``chip_smoke.py`` makes
them. It prints one JSON line per root and row, with SHA-256 digests of
dH's and of (dE, db)'s bytes, so that equal digests show two versions
give the same bits, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

TOOL_ROOT = Path(__file__).resolve().parents[1]
REPS = 10


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch  # noqa: F401  (root's package, before chip_smoke's)
    from repro_torch.configs.splade_bert import CONFIG
    from repro_torch.kernels.sparton_bwd import (sparton_backward_de,
                                                 sparton_backward_dh)
    from repro_torch.models.transformer import head_weights, init_params

    sys.path.insert(1, str(TOOL_ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(torch.Generator(device="cuda").manual_seed(0),
                         CONFIG)
    E, b = head_weights(params, CONFIG)
    E = E.to(torch.bfloat16)
    del params
    for name in chip_smoke.BWD_ROWS:
        H, _, dy, y, i_max = chip_smoke.bwd_timing_inputs(torch, E, b, name)
        S = H.shape[1]
        row = {"root": str(root), "row": name, "B": H.shape[0], "S": S}
        for kernel, run in (
                ("dh", lambda: sparton_backward_dh(dy, y, i_max, E, S)),
                ("de", lambda: sparton_backward_de(dy, y, i_max, H))):
            out = run()
            torch.cuda.synchronize()
            row[f"{kernel}_sha256"] = digest(*(
                out if isinstance(out, tuple) else (out,)))
            del out
            ms = chip_smoke.cuda_ms(torch, run, REPS)
            row[f"{kernel}_ms"] = ms
            row[f"{kernel}_ms_range"] = [min(chip_smoke.cuda_ms.windows),
                                         max(chip_smoke.cuda_ms.windows)]
        print(json.dumps(row), flush=True)
        del H, dy, y, i_max
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
