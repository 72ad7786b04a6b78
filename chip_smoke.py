"""Drive the PyTorch port's serving path on one NVIDIA H100.

    python3 chip_smoke.py            # one card, no arguments

Phases, run in this order, each printing one JSON line:

1. device  — ``nvidia-smi`` name and power limit, compute capability
             (9, 0) required.
2. build   — compile the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card.
4. serve   — the full-width splade_bert serving path: index 16384 docs,
             serve 64 requests through the batching loop, retrieve with
             ``method="auto"`` (which must resolve to the fused kernel).
5. timing  — each kernel, its plain version, a one-call PyTorch yardstick
             and its roofline bound, with CUDA events.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``. Any mismatch, exception or missing launch exits non-zero before
that last line. The script imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K1_TOL = 1e-4     # f32 sums over D in another order (both sides f32)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(cap), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    require(tuple(cap) == (9, 0), f"compute capability {cap}, need (9, 0)")


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    reports = {}
    for name in _build.SOURCES:
        log = (_build.build_dir() / f"{name}.log")
        lines = log.read_text().splitlines() if log.exists() else []
        reports[name] = [ln.strip() for ln in lines
                         if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, dir=str(_build.build_dir()),
         ptxas=reports)


# --------------------------------------------------------------------------
# 3. kernels against their plain versions
# --------------------------------------------------------------------------

K1_SHAPES = [  # (B, S, D, V): tests/test_kernels_sparton.py SHAPES, plus
    (1, 16, 8, 16), (4, 96, 64, 200), (3, 33, 24, 100),   # a D that is
    (8, 128, 128, 256), (2, 256, 32, 512), (3, 33, 20, 100),  # not % 8,
    (6, 32, 64, 200), (5, 20, 48, 130),   # 4 batch rows per block (S <= 32,
    (10, 12, 32, 150),                    # as served queries), and 8 (S <= 16)
]


def k1_inputs(torch, B, S, D, V, dtype, seed, *, mask_p=0.2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    H = torch.randn((B, S, D), generator=g, device="cuda").to(dtype)
    E = (torch.randn((V, D), generator=g, device="cuda") * 0.2).to(dtype)
    b = torch.randn((V,), generator=g, device="cuda") * 0.2
    mask = (torch.rand((B, S), generator=g, device="cuda") > mask_p).int()
    mask[:, 0] = 1
    return H, E, b, mask


def k1_compare(torch, H, E, b, mask, softcap):
    """Kernel vs plain on one input: (max |dy|, i_max mismatches beyond a
    near-tie). A mismatch is excused only where the two positions' logits
    differ by at most K1_TOL (the sums run in another order)."""
    from repro_torch.kernels.sparton import (sparton_forward,
                                             sparton_forward_plain)

    y_k, i_k = sparton_forward(H, E, b, mask, softcap=softcap)
    y_p, i_p = sparton_forward_plain(H, E, b, mask, softcap)
    torch.cuda.synchronize()
    err = (y_k - y_p).abs()
    require(bool((err <= K1_TOL + K1_TOL * y_p.abs()).all()),
            f"K1 y differs from the plain version by {err.max().item()}")
    bad = (i_k != i_p).nonzero()
    hard = 0
    if bad.numel():
        bb, vv = bad[:, 0], bad[:, 1]
        Hf, Ef = H.float(), E.float()

        def logit(s):
            z = (Hf[bb, s.long()] * Ef[vv]).sum(-1) + b[vv]
            return softcap * torch.tanh(z / softcap) if softcap else z

        gap = (logit(i_k[bb, vv]) - logit(i_p[bb, vv])).abs()
        hard = int((gap > K1_TOL * (1 + logit(i_p[bb, vv]).abs())).sum())
    return float(err.max()), int(bad.shape[0]), hard


def k4_cases(torch):
    """(name, w, docs, n_docs, k, term_lanes) with weights that are small
    multiples of 1/8, so every sum is exact whatever its order and the
    kernel must match the plain version bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cases = []

    def window(B, Q, L, n_docs, density):
        docs = torch.stack([torch.stack([
            torch.randperm(n_docs, generator=g, device="cuda")[:L]
            for _ in range(Q)]) for _ in range(B)]).int()
        w = torch.randint(1, 17, (B, Q, L), generator=g,
                          device="cuda").float() / 8
        w = w * (torch.rand((B, Q, L), generator=g, device="cuda")
                 < density)
        return w.reshape(B, -1).contiguous(), docs.reshape(B, -1).contiguous()

    w, d = window(6, 16, 40, 5000, 0.5)
    cases.append(("random", w, d, 5000, 10, 40))
    w, d = window(3, 4, 3, 1000, 1.0)           # 12 matches, k = 50
    cases.append(("zero_score_ties", w, d, 1000, 50, 3))
    w, d = window(2, 2, 2, 5, 1.0)
    cases.append(("k_gt_n_docs", w, d, 5, 8, 2))
    z = torch.zeros((3, 0), device="cuda")
    cases.append(("w_empty", z, z.int(), 64, 7, 1))
    w, d = window(4, 8, 16, 300, 1.0)
    w[1] = 0
    w[3] = 0
    cases.append(("empty_rows", w.contiguous(), d, 300, 12, 16))
    w, d = window(2, 8, 200, 70000, 0.7)        # three doc tiles
    cases.append(("multi_tile", w, d, 70000, 100, 200))
    return cases


def phase_kernels(torch):
    from repro_torch.kernels.impact_score import (fused_impact_topk,
                                                  fused_impact_topk_plain)
    from repro_torch.kernels.sparton import sparton_forward

    k1 = []
    worst_err, worst_hard = 0.0, 0
    seed = 0
    for (B, S, D, V) in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in (None, 5.0):
                seed += 1
                H, E, b, mask = k1_inputs(torch, B, S, D, V, dtype, seed)
                if B > 1:
                    mask[B - 1] = 0          # one fully masked row
                err, mism, hard = k1_compare(torch, H, E, b, mask, softcap)
                k1.append({"shape": [B, S, D, V], "dtype": str(dtype)[6:],
                           "softcap": softcap, "max_abs_err": err,
                           "imax_mismatch": mism, "imax_hard": hard})
                worst_err, worst_hard = max(worst_err, err), worst_hard + hard
    require(worst_hard == 0, f"K1 i_max disagrees beyond near-ties "
                             f"({worst_hard} positions)")
    # a bf16 H whose base is not 16-byte aligned takes the synchronous
    # loads (no cp.async)
    H, E, b, mask = k1_inputs(torch, 4, 96, 64, 200, torch.bfloat16, 98)
    H = torch.cat([H.new_zeros(1), H.reshape(-1)])[1:].view(H.shape)
    err, _, hard = k1_compare(torch, H, E, b, mask, None)
    worst_err, worst_hard = max(worst_err, err), worst_hard + hard
    require(hard == 0, "K1 i_max disagrees on an unaligned H")
    # a fully masked row gives y = 0, i_max = 0 on both sides
    H, E, b, mask = k1_inputs(torch, 3, 33, 24, 100, torch.bfloat16, 99)
    mask[1] = 0
    y, i = sparton_forward(H, E, b, mask)
    require(bool((y[1] == 0).all() and (i[1] == 0).all()),
            "K1 fully masked row is not (0, 0)")

    k4 = []
    k4_err, k4_mism = 0.0, 0
    for name, w, d, n_docs, k, lanes in k4_cases(torch):
        v_k, i_k = fused_impact_topk(w, d, n_docs=n_docs, k=k,
                                     term_lanes=lanes)
        v_p, i_p = fused_impact_topk_plain(w, d, n_docs=n_docs, k=k)
        torch.cuda.synchronize()
        err = float((v_k - v_p).abs().max()) if v_k.numel() else 0.0
        mism = int((i_k != i_p).sum())
        k4.append({"case": name, "max_abs_err": err, "id_mismatch": mism})
        k4_err, k4_mism = max(k4_err, err), k4_mism + mism
    require(k4_err == 0.0 and k4_mism == 0,
            f"K4 differs from the plain version (max err {k4_err}, "
            f"{k4_mism} id mismatches)")
    emit("kernels", k1_max_abs_err=worst_err, k1_tol=K1_TOL,
         k1_imax_mismatch=sum(c["imax_mismatch"] for c in k1),
         k1_cases=k1, k4_max_abs_err=k4_err, k4_id_mismatch=k4_mism,
         k4_cases=k4)


# --------------------------------------------------------------------------
# 4. serve at full width
# --------------------------------------------------------------------------

SERVE = {"corpus": 16384, "requests": 64, "index_batch": 64, "topk": 10,
         "rep_topk": 64}
SCORE_TOL = 1e-4   # fused vs impact sums: same terms, other add order


def phase_serve(torch):
    import dataclasses

    from repro_torch.configs.splade_bert import CONFIG
    from repro_torch.kernels import impact_score as k4
    from repro_torch.kernels import sparton as k1
    from repro_torch.launch.serve import run
    from repro_torch.models.transformer import init_params
    from repro_torch.retrieval.score import impact_scores, retrieve
    from repro_torch.runtime.serving import (FailedResult, ShedResult,
                                             make_config_encoder)

    cfg = dataclasses.replace(CONFIG, head_impl="kernel",
                              rep_topk=SERVE["rep_topk"])
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    encode = make_config_encoder(params, cfg)
    batches = []   # (B, S, seconds) of every encode call

    def timed_encode(tokens, mask):
        t0 = time.perf_counter()
        reps = encode(tokens, mask)
        torch.cuda.synchronize()
        batches.append((tokens.shape[0], tokens.shape[1],
                        time.perf_counter() - t0))
        return reps

    # the plain versions must never see a CUDA tensor on the main path
    plain_on_cuda = []
    originals = (k1.sparton_forward_plain, k4.fused_impact_topk_plain)

    def guard(name, fn):
        def wrapped(x, *a, **kw):
            if x.is_cuda:
                plain_on_cuda.append(name)
            return fn(x, *a, **kw)
        return wrapped

    k1.sparton_forward_plain = guard("k1", originals[0])
    k4.fused_impact_topk_plain = guard("k4", originals[1])
    k1.sparton_forward.launches = 0
    k4.fused_impact_topk.launches = 0
    try:
        res = run(timed_encode, cfg.vocab_size, corpus=SERVE["corpus"],
                  requests=SERVE["requests"], topk=SERVE["topk"],
                  method="auto", index_batch=SERVE["index_batch"],
                  device=torch.device("cuda"))
    finally:
        k1.sparton_forward_plain, k4.fused_impact_topk_plain = originals
    launches = {"sparton_fwd": k1.sparton_forward.launches,
                "impact_topk": k4.fused_impact_topk.launches}

    st = res["loop"].stats()
    unserved = [r for r in res["outcomes"].values()
                if isinstance(r, (ShedResult, FailedResult))]
    require(not unserved, f"{len(unserved)} requests not served "
                          f"({st['shed']} shed, {st['failed']} failed): "
                          f"{unserved[:2]!r}")
    require(res["method"] == "fused",
            f"auto resolved to {res['method']!r}, not 'fused'")
    require(launches["sparton_fwd"] == len(batches),
            f"K1 launched {launches['sparton_fwd']} times for "
            f"{len(batches)} encode batches")
    require(launches["impact_topk"] >= 1, "K4 never launched")
    require(not plain_on_cuda, f"plain versions ran on CUDA tensors: "
                               f"{sorted(set(plain_on_cuda))}")
    for rep in res["served"]:
        require(rep.width == SERVE["rep_topk"] and rep.nnz > 0
                and bool((rep.values >= 0).all()), "malformed query rep")

    # fused ids against the plain impact path on the same queries
    queries, index = res["queries"], res["index"]
    k = res["idx"].shape[1]
    v_i, i_i = retrieve(queries, index, k, method="impact")
    scores = impact_scores(queries, index)
    rows = torch.arange(scores.shape[0], device="cuda")[:, None]
    s_f = scores[rows, res["idx"].long()]
    s_i = scores[rows, i_i.long()]
    differ = res["idx"] != i_i
    near = (s_f - s_i).abs() <= SCORE_TOL * (1 + s_i.abs())
    require(bool((near | ~differ).all()),
            "fused ids differ from impact ids beyond near-ties")
    require(bool(torch.isfinite(res["vals"]).all()), "non-finite scores")
    val_err = float((res["vals"] - v_i).abs().max())
    require(val_err <= SCORE_TOL * (1 + float(v_i.abs().max())),
            f"fused scores differ from impact by {val_err}")

    n_query = len(res["loop"].batch_sizes)
    doc_ms = sorted(1e3 * t for _, _, t in batches[:-n_query])
    query_ms = [1e3 * t for _, _, t in batches[-n_query:]]
    lat = res["loop"].latencies()
    ist = index.stats()
    emit("serve", config=cfg.name, n_params=cfg.n_params,
         head_impl=cfg.head_impl, launches=launches,
         encode_batches=len(batches), index_s=res["index_s"],
         n_docs=ist["n_docs"], n_postings=ist["n_postings"],
         max_postings=ist["max_postings"],
         doc_batch_ms_median=doc_ms[len(doc_ms) // 2],
         query_batch_ms=query_ms, query_batches=list(res["loop"].batch_sizes),
         serve_s=res["serve_s"],
         p50_latency_ms=1e3 * float(np.percentile(lat, 50)),
         p99_latency_ms=1e3 * float(np.percentile(lat, 99)),
         retrieve_method=res["method"], retrieve_ms=1e3 * res["retrieve_s"],
         ids_differ=int(differ.sum()), near_ties=int((differ & near).sum()),
         fused_vs_impact_max_abs_err=val_err)
    return {"params": params, "cfg": cfg, "res": res, "launches": launches}


# --------------------------------------------------------------------------
# 5. timing
# --------------------------------------------------------------------------

WINDOWS = 5   # timed windows per measurement: median reported, spread kept


def cuda_ms(torch, fn, reps, warmup=1):
    """Milliseconds per call: CUDA events around ``reps`` back-to-back
    calls, in WINDOWS windows after a warm-up. Returns the median window
    and stores every window in ``cuda_ms.windows``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    cuda_ms.windows = times
    return sorted(times)[WINDOWS // 2]


def timed(torch, fn, reps):
    """``cuda_ms`` with its spread: (median ms, [min ms, max ms])."""
    ms = cuda_ms(torch, fn, reps)
    return ms, [min(cuda_ms.windows), max(cuda_ms.windows)]


def peak_mb(torch, fn):
    """Device memory a call allocates at its peak, above what was live."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def profile_encode(torch, encode, cfg, *, batch=64, seq=16, n=5):
    """Index-shaped encode batches (trunk, head, sparsifier, copy of the
    reps to the host): wall ms per batch untraced, then a torch.profiler
    trace of the same batches for the device time per batch, the
    device's busy share of the untraced wall time, and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.retrieval.sparse_rep import split_rows

    g = torch.Generator().manual_seed(11)
    toks = [torch.randint(1, cfg.vocab_size, (batch, seq), generator=g,
                          dtype=torch.int32) for _ in range(n + 1)]
    mask = torch.ones((batch, seq), dtype=torch.int32)

    def run():
        t0 = time.perf_counter()
        for t in toks[:n]:
            split_rows(encode(t, mask))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    split_rows(encode(toks[n], mask))             # warm-up
    wall_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = run()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kernels:
        return {"batch": [batch, seq], "wall_ms": wall_ms,
                "traced_wall_ms": traced_ms, "device_ms": "not measured"}
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"batch": [batch, seq], "wall_ms": wall_ms,
            "traced_wall_ms": traced_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_batch": sum(e.count for e in kernels) / n,
            "top_device_ms": {e.key[:70]: dev_us(e) / 1e3 / n for e in top}}


def k1_bound_ms(B, S, D, V, itemsize):
    flops = 2 * B * S * V * D
    nbytes = (B * S * D + V * D) * itemsize + V * 4 + B * S * 4 + B * V * 8
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k1_library(torch, H, E, b, mask):
    """The paper's PyTorch baseline: matmul, +b, relu, log1p, mask,
    amax over S (in place where it can be, to fit the Table-1 logits)."""
    z = torch.matmul(H, E.t())
    z += b.to(z.dtype)
    z.relu_()
    z.log1p_()
    z *= mask[:, :, None].to(z.dtype)
    return z.amax(dim=1)


def time_k1(torch, H, E, b, mask, *, reps, plain_reps):
    from repro_torch.kernels.sparton import (sparton_forward,
                                             sparton_forward_plain)

    err, mism, hard = k1_compare(torch, H, E, b, mask, None)
    require(hard == 0, f"K1 i_max disagrees beyond near-ties at "
                       f"{tuple(H.shape)} ({hard} positions)")
    B, S, D = H.shape
    V = E.shape[0]
    bound, by = k1_bound_ms(B, S, D, V, H.element_size())
    row = {"shape": [B, S, D, V], "dtype": str(H.dtype)[6:],
           "max_abs_err": err, "imax_mismatch": mism,
           "peak_mb": peak_mb(torch, lambda: sparton_forward(H, E, b, mask)),
           "library_peak_mb": peak_mb(torch, lambda: k1_library(
               torch, H, E, b, mask)),
           "bound_ms": bound, "bound_by": by}
    for key, fn, reps_ in (
            ("ms", lambda: sparton_forward(H, E, b, mask), reps),
            ("plain_ms", lambda: sparton_forward_plain(H, E, b, mask),
             plain_reps),
            ("library_ms", lambda: k1_library(torch, H, E, b, mask),
             plain_reps)):
        row[key], row[key + "_range"] = timed(torch, fn, reps_)
    torch.cuda.empty_cache()
    return row


def phase_timing(torch, served):
    from repro_torch.kernels.impact_score import (fused_impact_topk,
                                                  fused_impact_topk_plain,
                                                  fused_window_bytes)
    from repro_torch.models.transformer import forward_hidden, head_weights
    from repro_torch.retrieval.score import _fused_windows

    cfg, params, res = served["cfg"], served["params"], served["res"]
    g = torch.Generator(device="cuda").manual_seed(7)
    E, b = head_weights(params, cfg)
    E16 = E.to(torch.bfloat16)

    # K1 at the main path's shapes: real hidden states of an index batch
    # (64 docs x 16 tokens) and of a full query batch (16 queries of 4-24
    # tokens, padded to 32, as the loop serves them)
    rows = {}
    for name, (B, S, lo, hi) in (("index_batch", (64, 16, 16, 16)),
                                 ("query_batch", (16, 32, 4, 24))):
        toks = torch.randint(1, cfg.vocab_size, (B, S), generator=g,
                             device="cuda", dtype=torch.int32)
        lens = torch.randint(lo, hi + 1, (B, 1), generator=g, device="cuda")
        mask = (torch.arange(S, device="cuda") < lens).int()
        with torch.no_grad():
            H = forward_hidden(params, cfg, toks, mask)
        rows[name] = time_k1(torch, H, E16, b, mask, reps=20, plain_reps=5)
    # the paper's Table-1 point (B=320, S=512), random bf16 inputs
    from repro_torch.configs.splade_bert import SHAPES
    t1 = SHAPES["table1"]
    H = (torch.randn((t1.global_batch, t1.seq_len, cfg.d_model),
                     generator=g, device="cuda")).to(torch.bfloat16)
    mask = torch.ones((t1.global_batch, t1.seq_len), dtype=torch.int32,
                      device="cuda")
    rows["table1"] = time_k1(torch, H, E16, b, mask, reps=3, plain_reps=1)
    del H
    torch.cuda.empty_cache()

    # K4 at the serving shape: the served queries' windows on the index
    queries, index = res["queries"], res["index"]
    w, docs = _fused_windows(queries, index)
    k = res["idx"].shape[1]
    n = index.n_docs

    def k4_kernel():
        return fused_impact_topk(w, docs, n_docs=n, k=k,
                                 term_lanes=index.max_postings)

    flat_ids = (torch.arange(w.shape[0], device="cuda")[:, None] * n
                + docs.long()).view(-1)

    def k4_library():   # index_add_ into (B, N), then torch.topk
        flat = torch.zeros(w.shape[0] * n, device="cuda")
        flat.index_add_(0, flat_ids, w.view(-1))
        return torch.topk(flat.view(w.shape[0], n), k, dim=1)

    v_k, i_k = k4_kernel()
    v_p, i_p = fused_impact_topk_plain(w, docs, n_docs=n, k=k)
    k4_err = float((v_k - v_p).abs().max())
    B4, Q, L = w.shape[0], queries.width, index.max_postings
    k4_bytes = fused_window_bytes(B4, Q, L) + B4 * k * 8
    k4 = {"shape": {"B": B4, "Q": Q, "L": L, "n_docs": n, "k": k},
          "max_abs_err": k4_err,
          "bound_ms": 1e3 * k4_bytes / PEAK_BYTES, "bound_by": "bytes"}
    for key, fn in (("ms", k4_kernel),
                    ("plain_ms", lambda: fused_impact_topk_plain(
                        w, docs, n_docs=n, k=k)),
                    ("library_ms", k4_library)):
        k4[key], k4[key + "_range"] = timed(torch, fn, 20)
    from repro_torch.runtime.serving import make_config_encoder
    profile = profile_encode(torch, make_config_encoder(params, cfg), cfg)
    emit("timing", k1=rows, k4=k4, encode_profile=profile)

    launches = served["launches"]
    main_k1 = rows["index_batch"]
    kernels = [
        {"name": "sparton_fwd (K1)", "route": "cuda",
         "source": "src/repro_torch/csrc/sparton_fwd.cu",
         "replaces": "src/repro/kernels/sparton.py:52",
         "launches": launches["sparton_fwd"],
         **{key: main_k1[key] for key in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}},
        {"name": "impact_topk (K4)", "route": "cuda",
         "source": "src/repro_torch/csrc/impact_topk.cu",
         "replaces": "src/repro/kernels/impact_score.py:96",
         "launches": launches["impact_topk"],
         **{key: k4[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}},
    ]
    return kernels


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build()
    phase_kernels(torch)
    served = phase_serve(torch)
    print(json.dumps({"kernels": phase_timing(torch, served)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
