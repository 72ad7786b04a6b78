"""The dry run in the port against the JAX package, on the CPU:
``configs.all_cells``, ``configs.specs.cell_spec``,
``launch.steps.arch_config_for_cell`` and ``launch.dryrun._model_flops``
cell for cell; the step counter's abstract pass on meta tensors against
the same counter over a real CPU run of the same step (SMOKE configs,
every step kind); K1–K3's cost functions against the bounds ``PERF.md``
records and their meta branches; whether a published cell fits one card
against what the card has shown; and the CLI.

Tolerances: none. Shapes, dtypes, configs, FLOPs and bytes are integers
or exact formulas and are compared exactly; ``_model_flops`` evaluates
the same float expressions in the same order as the JAX function.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import all_cells as jax_all_cells
from repro.configs import specs as jax_specs
from repro.launch import steps as jax_steps
from repro_torch import configs
from repro_torch.configs import specs
from repro_torch.kernels import sparton, sparton_bwd
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.sparse import segment

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a, s, sp in jax_all_cells(True) if not sp.skip]
GNN_CELLS = [(a, s) for a, s in CELLS if a == "dimenet"]
# the JAX dry-run record's keys (repro/launch/dryrun.py's run_cell)
JAX_RECORD_KEYS = {
    "arch", "shape", "mesh", "status", "compile_s", "step_kind", "n_micro",
    "flops_per_device", "hbm_bytes_per_device", "collective_operand_bytes",
    "collective_wire_bytes", "collective_ops", "memory_analysis",
    "compute_s", "memory_s", "collective_s", "bottleneck",
    "model_flops_per_device", "useful_ratio"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "peak_estimate_bytes"}


def _ms(flops, nbytes, kind):
    return 1e3 * max(flops / ca.PEAK_FLOPS[kind], nbytes / ca.HBM_BYTES_PER_S)


# --- the matrix ------------------------------------------------------------

@pytest.mark.parametrize("paper", [False, True])
def test_all_cells_equal_the_jax_list(paper):
    ours = [(a, s, dataclasses.asdict(sp))
            for a, s, sp in configs.all_cells(paper)]
    theirs = [(a, s, dataclasses.asdict(sp))
              for a, s, sp in jax_all_cells(paper)]
    assert ours == theirs
    assert len(ours) == (45 if paper else 40)
    assert sum(c[2]["skip"] for c in ours) == 4
    assert list(configs.ARCH_IDS) == JAX_ARCH_IDS


def _jax_cell(arch, shape, dense):
    saved = jax_specs.DENSE_TRIPLETS
    jax_specs.DENSE_TRIPLETS = dense
    try:
        return jax_specs.cell_spec(arch, shape)
    finally:
        jax_specs.DENSE_TRIPLETS = saved


def _same_cell(ours, theirs):
    for f in dataclasses.fields(theirs):
        if f.name != "batch":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert list(ours.batch) == list(theirs.batch)
    for name, t in theirs.batch.items():
        assert tuple(ours.batch[name].shape) == tuple(t.shape), name
        assert (str(ours.batch[name].dtype).replace("torch.", "")
                == np.dtype(t.dtype).name), name


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_spec_equals_the_jax_cell_spec(arch, shape):
    _same_cell(specs.cell_spec(arch, shape), _jax_cell(arch, shape, True))


@pytest.mark.parametrize("arch,shape", GNN_CELLS)
def test_cell_spec_flat_triplets_equal_the_jax_flat_layout(arch, shape):
    """``dense_triplets=False`` is the JAX module's REPRO_DENSE_TRIPLETS=0."""
    _same_cell(specs.cell_spec(arch, shape, dense_triplets=False),
               _jax_cell(arch, shape, False))


def test_skipped_cells_raise():
    with pytest.raises(ValueError, match="skipped"):
        specs.cell_spec("llama3_2_3b", "long_500k")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arch_config_for_cell_equals_the_jax_config(arch, shape):
    ours = steps.arch_config_for_cell(arch, specs.cell_spec(arch, shape))
    theirs = jax_steps.arch_config_for_cell(arch,
                                            jax_specs.cell_spec(arch, shape))
    names = {f.name for f in dataclasses.fields(ours)}
    # the JAX TransformerConfig's scan and sharding knobs have no port
    assert names <= {f.name for f in dataclasses.fields(theirs)}
    for name in names - {"head_impl"}:   # the port's head is "kernel"
        assert getattr(ours, name) == getattr(theirs, name), name
    if "head_impl" in names:
        assert ours.head_impl == "kernel"


@pytest.fixture(scope="module")
def jax_model_flops():
    """The JAX ``_model_flops`` of every cell at one device, from one
    subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
    host devices, which must not reach this process."""
    code = (
        "import json\n"
        "from types import SimpleNamespace\n"
        "from repro.configs import all_cells\n"
        "from repro.configs.specs import cell_spec\n"
        "from repro.launch.dryrun import _model_flops\n"
        "mesh = SimpleNamespace(devices=SimpleNamespace(size=1))\n"
        "print(json.dumps({f'{a}/{s}': _model_flops(a, cell_spec(a, s), "
        "mesh) for a, s, sp in all_cells(True) if not sp.skip}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_jax_model_flops(arch, shape, jax_model_flops):
    ours = dryrun._model_flops(arch, specs.cell_spec(arch, shape))
    assert ours == jax_model_flops[f"{arch}/{shape}"]
    assert ours > 0


# --- the counter: meta against a real CPU run -------------------------------

# (arch, shape, rows, seq_len, candidates): SMOKE widths, batches cut to
# what the CPU runs in a second; a GNN cell keeps its published shapes
SMOKE_CELLS = [
    ("splade_bert", "table3_384", 2, 16, 0),        # lsr_train: K1-K3
    ("moonshot_v1_16b", "train_4k", 8, 8, 0),       # lsr_train, n_micro 8
    ("llama3_2_3b", "prefill_32k", 2, 20, 0),       # lsr_prefill: K1
    ("gemma2_27b", "decode_32k", 2, 24, 0),         # decode
    ("phi3_5_moe", "decode_32k", 2, 16, 0),         # decode (MoE)
    ("dimenet", "molecule", 0, 0, 0),               # gnn_train
    ("dimenet", "full_graph_sm", 0, 0, 0),          # gnn_train, dense
    ("dlrm_mlperf", "train_batch", 64, 0, 0),       # recsys_train
    ("xdeepfm", "train_batch", 64, 0, 0),
    ("dien", "train_batch", 32, 0, 0),
    ("wide_deep", "train_batch", 64, 0, 0),
    ("dien", "serve_p99", 32, 0, 0),                # recsys_serve
    ("xdeepfm", "serve_bulk", 48, 0, 0),
    ("dlrm_mlperf", "retrieval_cand", 1, 0, 70000),  # retrieval
    ("wide_deep", "retrieval_cand", 1, 0, 5000),
]


def _smoke(arch, shape, rows, seq, cand):
    cell = specs.cell_spec(arch, shape, smoke=True)
    if rows:
        cell = specs.with_rows(cell, rows, seq, cand)
    cfg = configs.get_config(arch).SMOKE
    if cell.d_feat:
        cfg = dataclasses.replace(cfg, d_feat=cell.d_feat)
    return cfg, cell


def _launches():
    return (sparton.sparton_forward.launches,
            dict(sparton.sparton_forward.path_launches),
            sparton_bwd.sparton_backward_dh.launches,
            sparton_bwd.sparton_backward_de.launches)


@pytest.mark.parametrize("arch,shape,rows,seq,cand", SMOKE_CELLS)
def test_meta_pass_counts_what_a_cpu_run_counts(arch, shape, rows, seq,
                                                cand, monkeypatch):
    """FLOPs by dtype and bytes equal exactly; on the kernel-free steps
    of the recsys and DimeNet cells the live-bytes peak too (the LSR
    steps' kernels allocate their scratch on meta, their plain versions
    other buffers on the CPU). No kernel launches on either. The CPU run
    takes the card's sorted segment sums, as the meta pass does."""
    monkeypatch.setattr(segment, "SORTED_SUM_DEVICES",
                        ("cuda", "meta", "cpu"))
    cfg, cell = _smoke(arch, shape, rows, seq, cand)
    before = _launches()
    meta = dryrun.count_step(cfg, cell)
    real = dryrun.count_step(cfg, cell, device="cpu")
    assert _launches() == before
    m, r = meta["counter"], real["counter"]
    assert dict(m.flops_by_dtype) == dict(r.flops_by_dtype)
    assert m.flops > 0
    assert m.bytes == r.bytes
    assert m.kernels == r.kernels
    assert meta["argument_bytes"] == real["argument_bytes"]
    assert meta["output_bytes"] == real["output_bytes"]
    if not m.kernels:
        assert m.peak_bytes == r.peak_bytes
    assert m.peak_bytes >= meta["argument_bytes"] + meta["output_bytes"]


def test_lsr_kernel_counts_follow_their_formulas():
    """The SMOKE train step calls K1 once a side and K2, K3 once a side in
    the backward; each count is the cost function's at the step's
    shapes (every position kept, every g != 0)."""
    cfg, cell = _smoke("splade_bert", "table3_384", 2, 16, 0)
    c = dryrun.count_step(cfg, cell)["counter"]
    B, S, D, V = 2, 16, cfg.d_model, cfg.vocab_size
    size = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    fwd = sparton.forward_cost(B, S, D, V, size)
    dh = sparton_bwd.dh_cost(B, S, D, V, size)
    de = sparton_bwd.de_cost(B, S, D, V, size)
    assert c.kernels == {
        "sparton_fwd": {"calls": 2, "flops": 2 * fwd[0], "bytes": 2 * fwd[1]},
        "sparton_bwd_dh": {"calls": 2, "flops": 2 * dh[0],
                           "bytes": 2 * dh[1]},
        "sparton_bwd_de": {"calls": 2, "flops": 2 * de[0],
                           "bytes": 2 * de[1]}}


def test_meta_branches_allocate_what_the_cuda_wrappers_do():
    """K2's meta branch allocates dH and its routing scratch, K1's y and
    i_max; no launch, and the cost goes to the running counter."""
    B, S, D, V = 3, 40, 16, 100
    dy = torch.empty((B, V), device="meta")
    i_max = torch.empty((B, V), dtype=torch.int32, device="meta")
    E = torch.empty((V, D), dtype=torch.bfloat16, device="meta")
    before = _launches()
    with ca.StepCounter() as c:
        dH = sparton_bwd.sparton_backward_dh(dy, dy, i_max, E, S)
    scratch = sum(ca._rounded(t.numel() * t.element_size())
                  for t in sparton_bwd.dh_scratch(B, S, V, "meta"))
    assert c.peak_bytes == ca._rounded(dH.numel() * 4) + scratch
    assert c.kernels["sparton_bwd_dh"] == {
        "calls": 1, "flops": 2 * B * V * D,
        "bytes": sparton_bwd.dh_cost(B, S, D, V, 2)[1]}
    H = torch.empty((B, S, D), dtype=torch.bfloat16, device="meta")
    with ca.StepCounter() as c:
        y, im = sparton.sparton_forward(H, E, torch.empty(V, device="meta"),
                                        torch.empty((B, S), device="meta",
                                                    dtype=torch.int32))
    assert (tuple(y.shape), y.dtype, im.dtype) == ((B, V), torch.float32,
                                                   torch.int32)
    assert c.kernels["sparton_fwd"]["flops"] == 2 * B * S * V * D
    assert c.flops_by_dtype == {"bf16": 2 * B * S * V * D}
    assert _launches() == before


@pytest.mark.parametrize("what,args,want", [
    ("k1 Table 1", (320, 512, 768, 30522, 2, None), 7.767),
    ("k1 384x256", (384, 256, 768, 30522, 2, 64841), 3.074),
])
def test_k1_cost_gives_the_recorded_bounds(what, args, want):
    flops, nbytes = sparton.forward_cost(*args)
    assert _ms(flops, nbytes, "bf16") == pytest.approx(want, abs=5e-4)


@pytest.mark.parametrize("cost", [sparton_bwd.dh_cost, sparton_bwd.de_cost])
def test_k2_k3_costs_give_the_recorded_bound(cost):
    """0.2687 ms at 384 x 256 (every g != 0 at random init): operations,
    2 * B * V * D f32 FLOP at 67 TFLOP/s."""
    flops, nbytes = cost(384, 256, 768, 30522, 2)
    assert flops / ca.PEAK_FLOPS["f32"] > nbytes / ca.HBM_BYTES_PER_S
    assert _ms(flops, nbytes, "f32") == pytest.approx(0.2687, abs=5e-5)


def test_roofline_sums_each_dtype_over_its_peak():
    r = ca.roofline_terms({"bf16": 989e12, "f32": 67e12}, 3.35e12,
                          model_flops=528e12)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(1.0)
    assert (r.collective_s, r.bottleneck) == (0.0, "compute")
    assert r.useful_ratio == pytest.approx(528 / 1056)


# --- which published cells fit one card -------------------------------------

@pytest.mark.parametrize("arch,shape,rows,fits", [
    ("xdeepfm", "train_batch", 0, False),       # out of memory on the card
    ("xdeepfm", "train_batch", 32768, True),    # trained there
    ("dlrm_mlperf", "train_batch", 0, False),   # 96.2 GB of tables
    ("dimenet", "ogb_products", 0, False),      # 253 GB of messages
    ("llama3_2_3b", "train_4k", 0, False),      # 16 of 28 layers at 4 x 4096
])
def test_fits_one_card_as_the_card_has_shown(arch, shape, rows, fits):
    cell = specs.cell_spec(arch, shape)
    if rows:
        cell = specs.with_rows(cell, rows)
    assert dryrun.fits_one_card(arch, shape, cell=cell) is fits


# --- the CLI ----------------------------------------------------------------

def test_cli_writes_the_jax_records_keys(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "splade_bert", "--json", str(out)]) == 0
    records = json.loads(out.read_text())
    assert [r["shape"] for r in records] == list(
        configs.get_config("splade_bert").SHAPES)
    for r in records:
        assert r["status"] == "ok"
        assert JAX_RECORD_KEYS <= set(r)
        assert set(r["memory_analysis"]) == MEMORY_KEYS
        assert r["mesh"] == "1" and r["collective_s"] == 0
        assert r["fits_one_card"] is True
        assert set(r["kernel_costs"]) == {"sparton_fwd", "sparton_bwd_dh",
                                          "sparton_bwd_de"}
        assert 0 < r["useful_ratio"] < 1


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_cli_meshes_exit_non_zero_naming_item_10(flag, capsys):
    assert dryrun.main([flag]) != 0
    assert "item 10" in capsys.readouterr().err


def test_build_step_refuses_a_mesh():
    cell = specs.cell_spec("xdeepfm", "serve_p99")
    with pytest.raises(NotImplementedError, match="item 10"):
        steps.build_step("xdeepfm", cell, mesh=object())
