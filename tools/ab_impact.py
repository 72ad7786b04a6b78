"""Compare K4 and K5 (the fused impact scorers) of one or more checkouts
of the PyTorch port on one CUDA card, on the same inputs, each checkout in
a process of its own.

    python3 tools/ab_impact.py ROOT [ROOT ...]

Each ROOT is a checkout whose ``src/`` holds ``repro_torch``; a root may be
named more than once, so that ``A B B A`` interleaves two versions within
one run on one card. First this checkout makes the inputs as
``chip_smoke.py`` makes them (its serve phase: splade_bert at full width
from seeded random weights, 16384 docs indexed, 64 requests served; its
engine phase: a quantized base of 19456 docs and a 64-doc delta) and saves
them under ``build/``. Then each root's process builds that checkout's
kernels and prints one JSON line with, for K4 on the serve index and K5 on
the engine's quantized base, at B 8 (the served queries) and B 64 (every
served request):

* the window entry (``fused_impact_topk`` / ``fused_quantized_topk`` on
  that checkout's windows) and, where the checkout has it, the index
  entry (``fused_impact_index_topk`` / ``fused_quantized_index_topk``):
  a SHA-256 digest of ``(vals, idx)`` (equal digests: the same bits) and
  the device ms per call (``chip_smoke.graph_ms``: CUDA-graph replays of
  back-to-back calls, median of its windows, and their range);
* the host ms of the serve path's ``retrieve(queries, index, 10,
  method=...)`` for ``fused`` and ``impact`` and of the engine's
  ``search(queries, 10, method=...)`` for ``auto``, ``fused`` and
  ``quantized`` (``chip_smoke.host_ms``): the median of REPS calls that
  each end in a synchronise, and their range;

then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

TOOL_ROOT = Path(__file__).resolve().parents[1]
INPUTS = TOOL_ROOT / "build" / "ab_impact_inputs.pt"
REPS = 30


def make_inputs() -> None:
    sys.path.insert(0, str(TOOL_ROOT))
    import torch

    import chip_smoke
    from repro_torch.retrieval.sparse_rep import stack_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    INPUTS.parent.mkdir(exist_ok=True)
    with open(INPUTS.with_suffix(".log"), "w") as log, \
            contextlib.redirect_stdout(log):
        served = chip_smoke.phase_serve(torch)
        engine = chip_smoke.phase_serve_engine(torch, served)["engine"]
    res = served["res"]
    torch.save({"queries": res["queries"], "served": stack_rows(res["served"]),
                "index": res["index"], "builder": engine.builder}, INPUTS)


def child(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch  # noqa: F401  (root's package, before chip_smoke's)
    from repro_torch.kernels import impact_score as k45
    from repro_torch.retrieval.engine.quantize import _fused_q_windows
    from repro_torch.retrieval.score import _fused_windows, retrieve

    sys.path.insert(1, str(TOOL_ROOT))
    import chip_smoke

    data = torch.load(INPUTS, weights_only=False)
    index, builder = data["index"], data["builder"]
    base = builder._base
    row = {"root": str(root)}
    for name, queries in (("B8", data["queries"]), ("B64", data["served"])):
        w, docs = _fused_windows(queries, index)
        wins = _fused_q_windows(queries, base)
        runs = {
            "k4_window": lambda: k45.fused_impact_topk(
                w, docs, n_docs=index.n_docs, k=10,
                term_lanes=index.max_postings),
            "k5_window": lambda: k45.fused_quantized_topk(
                *wins, n_docs=base.n_docs, k=10)}
        if hasattr(k45, "fused_impact_index_topk"):
            from repro_torch.retrieval.sparse_rep import query_columns
            qi, qv = query_columns(queries, index.device)
            # an older checkout's index entries also take the plain
            # version's window width
            takes_width = "max_postings" in inspect.signature(
                k45.fused_impact_index_topk).parameters
            w4 = {"max_postings": index.max_postings} if takes_width else {}
            w5 = {"max_postings": base.max_postings} if takes_width else {}
            runs["k4_index"] = lambda: k45.fused_impact_index_topk(
                qi, qv, index.term_starts, index.term_lens,
                index.postings_doc, index.postings_val, n_docs=index.n_docs,
                k=10, **w4)
            runs["k5_index"] = lambda: k45.fused_quantized_index_topk(
                qi, qv, base.term_starts, base.term_lens, base.packed_vals,
                base.deltas, base.term_lo, base.term_hi, n_docs=base.n_docs,
                k=10, **w5)
        for key, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            ms, spread = chip_smoke.graph_ms(torch, run, 20)
            row[f"{key}_{name}"] = {"digest": chip_smoke.digest(*out),
                                    "ms": ms, "ms_range": spread}
    queries = data["queries"]
    for method in ("fused", "impact"):
        row[f"retrieve_{method}_ms"] = chip_smoke.host_ms(
            torch, lambda: retrieve(queries, index, 10, method=method),
            REPS)
    for method in ("auto", "fused", "quantized"):
        row[f"search_{method}_ms"] = chip_smoke.host_ms(
            torch, lambda: builder.search(queries, 10, method=method), REPS)
    print(json.dumps(row), flush=True)


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
    rc = subprocess.run([sys.executable, "-c",
                         "import sys; sys.path.insert(0, 'src'); "
                         "sys.path.insert(0, 'tools'); "
                         "import ab_impact; ab_impact.make_inputs()"],
                        cwd=TOOL_ROOT).returncode
    if rc:
        return rc
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
