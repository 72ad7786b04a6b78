"""The dense decoders (llama3.2-3b, gemma2-27b, phi3-mini) in the port
against the JAX package, with the JAX SMOKE params carried over by
``weights.params_from_jax`` (CPU). The MoE decoders' configs, aliases and
train CLI ids are held here too; their trunks in
``test_torch_moe_decoder.py``.

Tolerances:

* configs and shapes: equal field for field;
* hidden states, logits and reps at f32 compute: rtol = atol = 1e-4
  (matmuls, softmax and norms summed in another order by another
  library, through two layers);
* at bf16 compute as ``test_torch_encoder.py`` states it: atol 0.1 on
  hidden states of magnitude up to ~4, with a mean-error bound of 0.02
  that a wrong layer, mask or window would break;
* decode against the full forward in the port alone, as the JAX
  package's ``test_decode_matches_full_forward``: f32 1e-4 (the JAX test
  holds its two paths to 1e-5; here the full forward walks the keys in
  chunks and the decode step takes the plain softmax), bf16 the JAX
  test's 8e-2 (the two paths round at different points).

The full widths run on the card only (``chip_smoke.py``'s ``decoder``
phase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.launch import serve, steps, train
from repro_torch.models import transformer as tfm
from repro_torch.weights import params_from_jax

DECODERS = ("llama3_2_3b", "gemma2_27b", "phi3_mini")
MOE = ("moonshot_v1_16b", "phi3_5_moe")
ALIASES = {"llama3.2-3b": "llama3_2_3b", "gemma2-27b": "gemma2_27b",
           "phi3-mini-3.8b": "phi3_mini",
           "moonshot-v1-16b-a3b": "moonshot_v1_16b",
           "phi3.5-moe-42b-a6.6b": "phi3_5_moe"}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4, mean=1e-5),
       "bfloat16": dict(rtol=0.0, atol=0.1, mean=0.02)}
# name: (S, attn_chunk) — within one chunk, and past it in 3 chunks (the
# last one short) and past gemma2's SMOKE window of 16
SHAPES = {"one_chunk": (12, None), "past_chunk_and_window": (40, 16)}


def _close(got: torch.Tensor, want, dtype: str) -> None:
    tol = TOL[dtype]
    ref = np.asarray(jnp.asarray(want, jnp.float32))
    out = got.float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"])
    assert np.abs(out - ref).mean() <= tol["mean"]


def _both(arch, compute_dtype="float32", chunk=None):
    over = {"compute_dtype": compute_dtype}
    if chunk is not None:
        over["attn_chunk"] = chunk
    cfg_j = dataclasses.replace(jax_config(arch).SMOKE, **over)
    cfg_t = dataclasses.replace(get_config(arch).SMOKE, **over)
    params_j = jtfm.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_j, params_j, cfg_t, params_from_jax(tree, cfg_t, "cpu")


def _tokens(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S * 3 // 4:] = 0              # a padded row
    return toks, mask


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS + MOE)
def test_configs_match_jax(arch):
    mod, jmod = get_config(arch), jax_config(arch)
    for name in ("CONFIG", "SMOKE"):
        cfg, jcfg = getattr(mod, name), getattr(jmod, name)
        fields = {f.name for f in dataclasses.fields(cfg)} - {"head_impl"}
        for field in fields:
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
        assert cfg.head_impl == "kernel"
        assert cfg.n_params == jcfg.n_params
        assert cfg.n_active_params == jcfg.n_active_params
    assert list(mod.SHAPES) == list(jmod.SHAPES)
    for key, spec in mod.SHAPES.items():
        jspec = jmod.SHAPES[key]
        for field in ("name", "kind", "seq_len", "global_batch", "skip",
                      "skip_reason"):
            assert getattr(spec, field) == getattr(jspec, field)


def test_llama_full_width_counts_3_213b_params():
    cfg = get_config("llama3_2_3b").CONFIG
    assert round(cfg.n_params / 1e9, 3) == 3.213
    assert cfg.tie_embeddings and cfg.param_dtype == "bfloat16"


@pytest.mark.parametrize("alias", list(ALIASES))
def test_aliases_resolve(alias):
    assert configs.resolve_arch(alias) == ALIASES[alias]
    assert get_config(alias) is get_config(ALIASES[alias])
    assert configs.ALIASES[alias] == jax_config.__globals__["ALIASES"][alias]


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt5")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_params_from_jax_takes_the_decoder_tree(arch):
    cfg_j, params_j, cfg_t, params_t = _both(arch)
    assert ("E" in params_t["lm_head"]) == (not cfg_t.tie_embeddings)
    mine = tfm.init_params(torch.Generator().manual_seed(0), cfg_t)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(params_j)[0])
    assert len(flat_j) == len(jax.tree.leaves(mine))
    for path, got in zip(sorted(jax.tree_util.keystr(p) for p in flat_j),
                         sorted(jax.tree_util.keystr(p) for p, _ in
                                jax.tree_util.tree_flatten_with_path(
                                    jax.tree.map(np.asarray, mine))[0])):
        assert path == got
    E, _ = tfm.head_weights(params_t, cfg_t)
    Ej, _ = jtfm.head_weights(params_j, cfg_j)
    np.testing.assert_array_equal(E.numpy(), np.asarray(Ej))
    tree = jax.tree.map(np.asarray, params_j)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, cfg_t, "cpu")


def test_compute_weights_does_not_copy_a_bf16_embedding():
    cfg = dataclasses.replace(get_config("gemma2_27b").SMOKE,
                              param_dtype="bfloat16")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    served = tfm.compute_weights(params, cfg)
    assert served["embed"] is params["embed"]
    assert tfm.head_weights(served, cfg)[0] is params["embed"]


# ---------------------------------------------------------------------------
# the trunk and the heads against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_forward_hidden_matches_jax(arch, dtype, shape):
    S, chunk = SHAPES[shape]
    cfg_j, params_j, cfg_t, params_t = _both(arch, dtype, chunk)
    toks, mask = _tokens(cfg_t, S=S)
    H_j, _ = jtfm.forward_hidden(params_j, cfg_j, jnp.asarray(toks),
                                 jnp.asarray(mask))
    H_t = tfm.forward_hidden(params_t, cfg_t, torch.from_numpy(toks),
                             torch.from_numpy(mask))
    assert H_t.dtype == getattr(torch, dtype)
    _close(H_t, H_j, dtype)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", DECODERS)
def test_causal_lm_logits_match_jax(arch, shape):
    S, chunk = SHAPES[shape]
    cfg_j, params_j, cfg_t, params_t = _both(arch, "float32", chunk)
    toks, mask = _tokens(cfg_t, S=S, seed=1)
    want, _ = jtfm.causal_lm_logits(params_j, cfg_j, jnp.asarray(toks),
                                    jnp.asarray(mask))
    got = tfm.causal_lm_logits(params_t, cfg_t, torch.from_numpy(toks),
                               torch.from_numpy(mask))
    assert got.shape == (2, S, cfg_t.vocab_size)
    assert got.dtype == torch.float32
    if cfg_t.final_logit_softcap:
        assert float(got.abs().max()) < cfg_t.final_logit_softcap
    _close(got, want, "float32")


@pytest.mark.parametrize("impl", ["kernel", "sparton"])
@pytest.mark.parametrize("arch", DECODERS)
def test_lsr_prefill_step_matches_jax(arch, impl):
    """The paper's head on a decoder backbone: K1's plain version on the
    CPU ("kernel") and the plain streaming head ("sparton") against the
    JAX step with its own head, past one chunk and gemma2's window."""
    S, chunk = SHAPES["past_chunk_and_window"]
    cfg_j, params_j, cfg_t, params_t = _both(arch, "float32", chunk)
    toks, mask = _tokens(cfg_t, S=S, seed=2)
    want = jsteps.build_lsr_prefill_step(cfg_j, None, 2)(
        params_j, {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)})
    serve_fn = steps.build_lsr_prefill_step(
        dataclasses.replace(cfg_t, head_impl=impl), n_batch=2)
    got = serve_fn(params_t, {"tokens": torch.from_numpy(toks),
                              "mask": torch.from_numpy(mask)})
    assert got.shape == (2, cfg_t.vocab_size) and not got.requires_grad
    assert bool((got >= 0).all())
    _close(got, want, "float32")


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_jax(arch):
    """Six decode steps from an empty cache, two rows at other positions:
    the logits and both caches against the JAX function's."""
    cfg_j, params_j, cfg_t, params_t = _both(arch)
    B, S_max, n = 2, 10, 6
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg_t.vocab_size, size=(B, n)).astype(np.int32)
    cache_j = jtfm.init_kv_cache(cfg_j, B, S_max)
    cache_t = tfm.init_kv_cache(cfg_t, B, S_max, device="cpu")
    for s in range(n):
        pos = np.array([s, s + 3], np.int32)
        logits_j, cache_j = jtfm.decode_step(
            params_j, cfg_j, cache_j, jnp.asarray(toks[:, s:s + 1]),
            jnp.asarray(pos))
        logits_t, cache_t = tfm.decode_step(
            params_t, cfg_t, cache_t, torch.from_numpy(toks[:, s:s + 1]),
            torch.from_numpy(pos))
        _close(logits_t, logits_j, "float32")
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_full_forward(arch, dtype):
    """The port's copy of the JAX package's
    ``test_decode_matches_full_forward``: token-by-token decode logits
    equal the full (teacher-forced) forward's at each position, here
    past gemma2's window of 16 and past one chunk of keys."""
    cfg = dataclasses.replace(get_config(arch).SMOKE, compute_dtype=dtype,
                              attn_chunk=8)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 24
    toks = torch.randint(1, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full = tfm.causal_lm_logits(params, cfg, toks)
    decode = steps.build_decode_step(cfg)
    cache = tfm.init_kv_cache(cfg, B, S, device="cpu")
    atol = 1e-4 if dtype == "float32" else 8e-2
    for s in range(S):
        logits, ck, cv = decode(params, {
            "tokens": toks[:, s:s + 1],
            "positions": torch.full((B,), s, dtype=torch.int32),
            "cache_k": cache["k"], "cache_v": cache["v"]})
        assert ck is cache["k"] and cv is cache["v"]      # in place
        torch.testing.assert_close(logits.float(), full[:, s].float(),
                                   atol=atol, rtol=atol)


def test_local_global_alternation_matters():
    """gemma2's even layers attend within the window of 16, its odd layers
    globally: changing the first token reaches the last of 40 positions
    through the global layer, and not at all when every layer is local
    (two local layers see back 30 positions). The port and the JAX
    package agree on both."""
    base = get_config("gemma2_27b").SMOKE
    assert base.sliding_window == 16 and base.local_global_alternating
    assert [tfm.layer_window(base, i) for i in range(4)] == [16, None] * 2
    for alternating in (True, False):
        cfg_j, params_j, cfg_t, params_t = _both("gemma2_27b")
        cfg_t = dataclasses.replace(cfg_t, local_global_alternating=alternating)
        cfg_j = dataclasses.replace(cfg_j, local_global_alternating=alternating)
        toks = _tokens(cfg_t, B=2, S=40, seed=4)[0][:1]
        toks2 = toks.copy()
        toks2[0, 0] = toks[0, 0] % (cfg_t.vocab_size - 2) + 1
        H1, H2 = (tfm.forward_hidden(params_t, cfg_t, torch.from_numpy(t))
                  for t in (toks, toks2))
        changed = float((H1[0, -1] - H2[0, -1]).abs().max())
        assert (changed > 0) == alternating
        H_j, _ = jtfm.forward_hidden(params_j, cfg_j, jnp.asarray(toks))
        _close(H1, H_j, "float32")


# ---------------------------------------------------------------------------
# the steps' contracts
# ---------------------------------------------------------------------------

def test_init_kv_cache_layout():
    cfg = get_config("gemma2_27b").SMOKE
    cache = tfm.init_kv_cache(cfg, 3, 20, device="cpu")
    for key in ("k", "v"):
        assert cache[key].shape == (cfg.n_layers, 3, 20, cfg.n_kv_heads,
                                    cfg.d_head)
        assert cache[key].dtype == torch.bfloat16
        assert not cache[key].any()
    f32 = tfm.init_kv_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
    assert f32["k"].dtype == torch.float32


def test_decode_writes_the_cache_at_the_given_positions():
    cfg = dataclasses.replace(get_config("llama3_2_3b").SMOKE,
                              compute_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    cache = tfm.init_kv_cache(cfg, 2, 6, device="cpu")
    logits, ck, cv = steps.build_decode_step(cfg)(params, {
        "tokens": torch.tensor([[5], [7]], dtype=torch.int32),
        "positions": torch.tensor([0, 3], dtype=torch.int32),
        "cache_k": cache["k"], "cache_v": cache["v"]})
    assert logits.shape == (2, cfg.vocab_size)
    written = ck.abs().sum(dim=(3, 4)) > 0          # (L, B, S_max)
    want = torch.zeros_like(written)
    want[:, 0, 0] = want[:, 1, 3] = True
    assert torch.equal(written, want)
    assert torch.equal(cv.abs().sum(dim=(3, 4)) > 0, want)


@pytest.mark.parametrize("build", ["prefill", "decode"])
def test_a_mesh_is_refused_naming_item_10(build):
    cfg = get_config("llama3_2_3b").SMOKE
    with pytest.raises(NotImplementedError, match="item 10"):
        if build == "prefill":
            steps.build_lsr_prefill_step(cfg, mesh=object(), n_batch=2)
        else:
            steps.build_decode_step(cfg, mesh=object())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_2_3b", "llama3.2-3b"])
def test_serve_cli_serves_a_decoder_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--corpus", "48",
                       "--requests", "6", "--method", "fused"]) == 0
    out = capsys.readouterr().out
    assert "encoded 6/6 requests" in out
    assert "retrieval[fused]: top-10 for 6 queries" in out


@pytest.mark.parametrize("arch", ["llama3_2_3b", "gemma2-27b", "phi3_mini",
                                  "moonshot_v1_16b", "phi3.5-moe-42b-a6.6b"])
def test_train_cli_refuses_a_decoder(arch, capsys, tmp_path):
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "12b" in err and "splade_bert" in err
