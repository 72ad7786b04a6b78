"""K1 alone on the card: build, its gates, and its times at the main path's
shapes, without the serving and training phases of ``chip_smoke.py``.

    python3 tools/k1_check.py             # build, gates, one full-width shape
    python3 tools/k1_check.py --time      # ... and time K1 at 64 x 16,
                                          # 16 x 32, 384 x 256 and 320 x 512
    python3 tools/k1_check.py --decoder-train
                                          # ... and K1 at the decoders'
                                          # train shapes (B 2 x S 4096)

Prints ``chip_smoke.py``'s device and build lines (ptxas's report
included), one JSON line of gates, and with ``--time`` one JSON line per
shape: the "tma" path beside the earlier WMMA design forced on the same
inputs (``ms_wmma``), the plain version, the paper's PyTorch baseline
and the bound. The inputs are seeded random bf16 hidden states with
``splade_bert``'s widths (D 768, V 30522). With ``--decoder-train``, one
JSON line per decoder of ``DECODER_TRAIN`` at B 2 x S 4096 (train_4k's
length, the decoders' train steps): K1 at that decoder's D, V and final
softcap on seeded random bf16 weights, beside its plain version, the
one-call yardstick and the paper's PyTorch baseline head (``naive``),
each called alone (``chip_smoke.time_k1_decoder``). Exits non-zero on
any failed gate.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on sys.path)

SHAPES = {"index_batch": (64, 16), "query_batch": (16, 32),
          "train": (384, 256), "table1": (320, 512)}
# the decoders whose train steps chip_smoke.py times, at their (B, S)
DECODER_TRAIN = {"llama3_2_3b": (2, 4096), "gemma2_27b": (2, 4096),
                 "moonshot_v1_16b": (2, 4096)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--decoder-train", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1_check: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch.kernels import sparton as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    cases = chip_smoke.k1_gates(torch)
    B, S, D, V = chip_smoke.WIDE_B
    wide = [chip_smoke.k1_compare(
        torch, *chip_smoke.k1_inputs(torch, B, S, D, V, dtype, 65), None)
        for dtype in (torch.bfloat16, torch.float32)]
    chip_smoke.require(all(w["imax_hard"] == 0 and w["bit_identical"]
                           for w in wide), f"K1 at B {B}: {wide}")
    g = torch.Generator(device="cuda").manual_seed(17)
    H = torch.randn((384, 256, 768), generator=g,
                    device="cuda").to(torch.bfloat16)
    E = (torch.randn((30522, 768), generator=g, device="cuda")
         * 0.05).to(torch.bfloat16)
    b = torch.randn((30522,), generator=g, device="cuda") * 0.2
    lens = torch.randint(77, 257, (384, 1), generator=g, device="cuda")
    mask = (torch.arange(256, device="cuda") < lens).int()
    full = chip_smoke.k1_compare(torch, H, E, b, mask, None)
    chip_smoke.require(full["imax_hard"] == 0 and full["bit_identical"],
                       f"K1 at 384 x 256: {full}")
    del H
    print(json.dumps({"phase": "k1_gates",
                      "cases": len(cases),
                      "paths": {p: sum(c["path"] == p for c in cases)
                                for p in k1.PATHS},
                      "max_abs_err": max(c["max_abs_err"] for c in cases),
                      "imax_mismatch": sum(c["imax_mismatch"]
                                           for c in cases),
                      "wide_b": wide, "train_shape": full}), flush=True)
    if args.time:
        for name, (B, S) in SHAPES.items():
            H = torch.randn((B, S, 768), generator=g,
                            device="cuda").to(torch.bfloat16)
            lens = torch.randint(max(1, int(0.3 * S)), S + 1, (B, 1),
                                 generator=g, device="cuda")
            mask = (torch.arange(S, device="cuda") < lens).int()
            small = B * S <= 2048
            row = chip_smoke.time_k1(torch, H, E, b, mask,
                                     reps=20 if small else 3,
                                     plain_reps=5 if small else 1)
            print(json.dumps({"phase": "k1_time", "shape": name, **row}),
                  flush=True)
            del H
            torch.cuda.empty_cache()
    if args.decoder_train:
        from repro_torch.configs import get_config

        for arch, (B, S) in DECODER_TRAIN.items():
            cfg = get_config(arch).CONFIG
            D, V = cfg.d_model, cfg.vocab_size
            E = (torch.randn((V, D), generator=g, device="cuda")
                 * D ** -0.5).to(torch.bfloat16)
            b = torch.randn((V,), generator=g, device="cuda") * 0.02
            row = chip_smoke.time_k1_decoder(torch, E, b, B, S,
                                             cfg.final_logit_softcap)
            print(json.dumps({"phase": "k1_decoder_train", "arch": arch,
                              **row}), flush=True)
            del E, b
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except chip_smoke.SmokeFailure as exc:
        print(f"k1_check: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
