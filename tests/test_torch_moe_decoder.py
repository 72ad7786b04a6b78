"""The MoE decoders (moonshot-v1-16b-a3b, phi3.5-moe) in the port against
the JAX package, with the JAX SMOKE params carried over by
``weights.params_from_jax`` (CPU).

Tolerances:

* configs and shapes: equal field for field, ``n_params`` and
  ``n_active_params`` equal;
* hidden states, logits, reps and caches at f32 compute: rtol = atol =
  1e-4, with a mean-error bound of 1e-5 (``test_torch_decoder.py``'s f32
  rows: two layers of products summed in another order); the aux loss
  1e-5 (f32 means of the same routing);
* decode against the full forward in the port alone at f32: 1e-4 (as
  ``test_torch_decoder.py``), at a capacity that drops nothing
  (``capacity_factor = n_experts`` gives C = top_k * T >= T): at the
  configs' 1.25 the decode step's capacity (that of B tokens) and the
  full forward's (B * S tokens) drop other assignments, in the reference
  as in the port.

The whole trunks are held at f32 only: at bf16 a hidden state that rounds
differently can route a token to another expert and move it by O(1);
``test_torch_moe.py`` holds ``moe_ffn`` alone at bf16 on identical
inputs. The full widths run on the card only (``chip_smoke.py``'s ``moe``
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
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as tfm
from repro_torch.weights import params_from_jax

MOE = ("moonshot_v1_16b", "phi3_5_moe")
ALIASES = {"moonshot-v1-16b-a3b": "moonshot_v1_16b",
           "phi3.5-moe-42b-a6.6b": "phi3_5_moe"}
TOL = dict(rtol=1e-4, atol=1e-4, mean=1e-5)
AUX_TOL = dict(rtol=1e-5, atol=1e-5)
# name: (S, attn_chunk): within one chunk, and past it in 3 chunks
SHAPES = {"one_chunk": (12, None), "past_chunk": (40, 16)}


def _close(got: torch.Tensor, want) -> None:
    ref = np.asarray(jnp.asarray(want, jnp.float32))
    out = got.float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=TOL["rtol"], atol=TOL["atol"])
    assert np.abs(out - ref).mean() <= TOL["mean"]


def _both(arch, chunk=None, **over):
    over = {"compute_dtype": "float32", **over}
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

@pytest.mark.parametrize("alias", list(ALIASES))
def test_moe_aliases_resolve_to_the_moe_modules(alias):
    name = ALIASES[alias]
    assert configs.resolve_arch(alias) == name == configs.resolve_arch(name)
    assert get_config(alias) is get_config(name)
    assert get_config(name).__name__ == f"repro_torch.configs.{name}"
    assert get_config(name).CONFIG.is_moe and get_config(name).SMOKE.is_moe
    assert configs.ALIASES[alias] == jax_config.__globals__["ALIASES"][alias]
    assert name in configs.ARCHS and name not in configs.TRAIN_ARCHS


@pytest.mark.parametrize("arch", MOE)
def test_moe_param_counts(arch):
    """``n_params`` and ``n_active_params`` are the reference's formulas:
    moonshot's 48 layers of 64 experts make 27.72 B parameters, not the
    16 B of its id (the port keeps the reference's fields)."""
    cfg = get_config(arch).CONFIG
    want = {"moonshot_v1_16b": (27_722_448_896, 3_638_755_328),
            "phi3_5_moe": (41_872_523_264, 6_640_369_664)}[arch]
    assert (cfg.n_params, cfg.n_active_params) == want
    assert jax_config(arch).CONFIG.n_params == want[0]
    assert jax_config(arch).CONFIG.n_active_params == want[1]
    dense = get_config("llama3_2_3b").CONFIG
    assert dense.n_active_params == dense.n_params
    assert cfg.capacity_factor == 1.25 and cfg.aux_weight == 1e-2


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_takes_the_moe_tree(arch):
    cfg_j, params_j, cfg_t, params_t = _both(arch)
    mlp = params_t["layers"]["mlp"]
    L, D, Fd, E = (cfg_t.n_layers, cfg_t.d_model, cfg_t.d_ff,
                   cfg_t.n_experts)
    assert {k: tuple(v.shape) for k, v in mlp.items()} == {
        "router": (L, D, E), "w_gate": (L, E, D, Fd),
        "w_up": (L, E, D, Fd), "w_down": (L, E, Fd, D)}
    np.testing.assert_array_equal(
        mlp["w_down"].numpy(), np.asarray(params_j["layers"]["mlp"]["w_down"]))
    # the port's own init builds the same tree
    mine = tfm.init_params(torch.Generator().manual_seed(0), cfg_t)
    paths = sorted(jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_flatten_with_path(params_j)[0])
    assert paths == sorted(jax.tree_util.keystr(p) for p, _ in
                           jax.tree_util.tree_flatten_with_path(
                               jax.tree.map(np.asarray, mine))[0])
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert mine["layers"]["mlp"][name].shape == mlp[name].shape


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_refuses_a_dense_tree_and_the_other_way(arch):
    cfg_t = get_config(arch).SMOKE
    dense = dataclasses.replace(cfg_t, family="dense", n_experts=0, top_k=0)
    dense_tree = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(
            jax_config(arch).SMOKE, family="dense", n_experts=0, top_k=0)))
    with pytest.raises(ValueError, match="an MoE"):
        params_from_jax(dense_tree, cfg_t, "cpu")
    moe_tree = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), jax_config(arch).SMOKE))
    with pytest.raises(ValueError, match="a dense"):
        params_from_jax(moe_tree, dense, "cpu")
    moe_tree["layers"]["mlp"]["router"] = \
        moe_tree["layers"]["mlp"]["router"][..., :-1]
    with pytest.raises(ValueError, match="router has shape"):
        params_from_jax(moe_tree, cfg_t, "cpu")


def test_compute_weights_keeps_the_router_in_its_param_dtype():
    """The reference up-casts the router to f32 at each call; a bf16 copy
    would change routing on f32-param configs (SMOKE)."""
    cfg = get_config("moonshot_v1_16b").SMOKE
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    served = tfm.compute_weights(params, cfg)
    mlp = served["layers"]["mlp"]
    assert mlp["router"] is params["layers"]["mlp"]["router"]
    assert mlp["router"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert mlp[name].dtype == torch.bfloat16
    toks = torch.randint(1, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, aux_a = tfm.forward_hidden(params, cfg, toks, return_aux=True)
        b, aux_b = tfm.forward_hidden(served, cfg, toks, return_aux=True)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# the trunk and the heads against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", MOE)
def test_forward_hidden_and_aux_match_jax(arch, shape):
    S, chunk = SHAPES[shape]
    cfg_j, params_j, cfg_t, params_t = _both(arch, chunk)
    toks, mask = _tokens(cfg_t, S=S)
    H_j, aux_j = jtfm.forward_hidden(params_j, cfg_j, jnp.asarray(toks),
                                     jnp.asarray(mask))
    H_t, aux_t = tfm.forward_hidden(params_t, cfg_t, torch.from_numpy(toks),
                                    torch.from_numpy(mask), return_aux=True)
    assert H_t.dtype == torch.float32 and aux_t.shape == ()
    _close(H_t, H_j)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **AUX_TOL)
    # the default return is H alone, the same tensor
    H_only = tfm.forward_hidden(params_t, cfg_t, torch.from_numpy(toks),
                                torch.from_numpy(mask))
    assert torch.equal(H_only, H_t)


@pytest.mark.parametrize("arch", MOE)
def test_causal_lm_logits_match_jax(arch):
    S, chunk = SHAPES["past_chunk"]
    cfg_j, params_j, cfg_t, params_t = _both(arch, chunk)
    toks, mask = _tokens(cfg_t, S=S, seed=1)
    want, _ = jtfm.causal_lm_logits(params_j, cfg_j, jnp.asarray(toks),
                                    jnp.asarray(mask))
    got = tfm.causal_lm_logits(params_t, cfg_t, torch.from_numpy(toks),
                               torch.from_numpy(mask))
    assert got.shape == (2, S, cfg_t.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("impl", ["kernel", "sparton"])
@pytest.mark.parametrize("arch", MOE)
def test_lsr_prefill_step_matches_jax(arch, impl):
    """The paper's head on an MoE backbone: K1's plain version on the CPU
    ("kernel") and the plain streaming head ("sparton") against the JAX
    step with its own head, past one chunk."""
    S, chunk = SHAPES["past_chunk"]
    cfg_j, params_j, cfg_t, params_t = _both(arch, chunk)
    toks, mask = _tokens(cfg_t, S=S, seed=2)
    want = jsteps.build_lsr_prefill_step(cfg_j, None, 2)(
        params_j, {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)})
    serve_fn = steps.build_lsr_prefill_step(
        dataclasses.replace(cfg_t, head_impl=impl), n_batch=2)
    got = serve_fn(params_t, {"tokens": torch.from_numpy(toks),
                              "mask": torch.from_numpy(mask)})
    assert got.shape == (2, cfg_t.vocab_size) and not got.requires_grad
    assert bool((got >= 0).all())
    _close(got, want)


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_matches_jax(arch):
    """Six decode steps from an empty cache, two rows at other positions,
    at the configs' capacity (that of a 2-token call: C = 1, so some
    steps drop an assignment in both): the logits and both caches against
    the JAX function's."""
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
        _close(logits_t, logits_j)
    for key in ("k", "v"):
        _close(cache_t[key], cache_j[key])


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_full_forward_without_drops(arch):
    """Token-by-token decode logits equal the full forward's at each
    position at f32 when no assignment drops (``capacity_factor =
    n_experts``), past one chunk of keys."""
    base = get_config(arch).SMOKE
    cfg = dataclasses.replace(base, compute_dtype="float32", attn_chunk=8,
                              capacity_factor=float(base.n_experts))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    B, S = 2, 20
    toks = torch.randint(1, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full = tfm.causal_lm_logits(params, cfg, toks)
    decode = steps.build_decode_step(cfg)
    cache = tfm.init_kv_cache(cfg, B, S, device="cpu")
    for s in range(S):
        logits, ck, cv = decode(params, {
            "tokens": toks[:, s:s + 1],
            "positions": torch.full((B,), s, dtype=torch.int32),
            "cache_k": cache["k"], "cache_v": cache["v"]})
        assert ck is cache["k"] and cv is cache["v"]      # in place
        torch.testing.assert_close(logits, full[:, s], atol=1e-4, rtol=1e-4)


def test_moe_aux_loss_nonzero_and_finite():
    """The port's copy of the JAX package's
    ``test_moe_aux_loss_nonzero_and_finite``, on the port's own init."""
    cfg = get_config("moonshot_v1_16b").SMOKE
    state = steps.init_state("moonshot_v1_16b",
                             torch.Generator().manual_seed(0), smoke=True)
    rng = np.random.default_rng(0)
    B, S = 4, 24
    n_valid = rng.integers(S // 2, S + 1, size=B)
    mask = (np.arange(S)[None] < n_valid[:, None]).astype(np.int32)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)) * mask
    with torch.no_grad():
        H, aux = tfm.forward_hidden(state["params"], cfg,
                                    torch.from_numpy(toks),
                                    torch.from_numpy(mask), return_aux=True)
    assert H.shape == (B, S, cfg.d_model)
    assert bool(torch.isfinite(H.float()).all())
    assert bool(torch.isfinite(aux)) and float(aux) > 0


def test_dense_trunk_aux_is_zero():
    cfg = dataclasses.replace(get_config("llama3_2_3b").SMOKE,
                              compute_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(1, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    H, aux = tfm.forward_hidden(params, cfg, toks, return_aux=True)
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    assert torch.equal(H, tfm.forward_hidden(params, cfg, toks))


def test_remat_trunk_gives_the_same_h_aux_and_grads():
    """With autograd on and ``remat`` the layers run under
    ``torch.utils.checkpoint`` and hand the aux loss through it: the same
    H and aux as without, and the gradients of ``H.sum() + aux`` reach
    the router and every expert."""
    cfg = dataclasses.replace(get_config("phi3_5_moe").SMOKE,
                              compute_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(1, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        live = {"embed": params["embed"], "final_norm": params["final_norm"],
                "lm_head": params["lm_head"],
                "layers": {**params["layers"], "mlp": {
                    k: v.detach().requires_grad_(True)
                    for k, v in params["layers"]["mlp"].items()}}}
        H, aux = tfm.forward_hidden(live, c, toks, return_aux=True)
        grads = torch.autograd.grad(H.sum() + aux,
                                    list(live["layers"]["mlp"].values()))
        out[remat] = (H.detach(), aux.detach(), grads)
    (H0, a0, g0), (H1, a1, g1) = out[False], out[True]
    assert torch.equal(H0, H1) and torch.equal(a0, a1)
    for x, y in zip(g0, g1):
        assert bool(torch.isfinite(x).all()) and float(x.abs().sum()) > 0
        torch.testing.assert_close(x, y)


# ---------------------------------------------------------------------------
# the steps' contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", ["prefill", "decode"])
@pytest.mark.parametrize("arch", MOE)
def test_a_mesh_is_refused_naming_item_10(arch, build):
    cfg = get_config(arch).SMOKE
    with pytest.raises(NotImplementedError, match="item 10"):
        if build == "prefill":
            steps.build_lsr_prefill_step(cfg, mesh=object(), n_batch=2)
        else:
            steps.build_decode_step(cfg, mesh=object())


@pytest.mark.parametrize("build", ["train_step", "loss"])
@pytest.mark.parametrize("arch", MOE)
def test_training_an_moe_config_is_refused_naming_12b(arch, build):
    """The reference's objective adds ``aux_weight * (aux_q + aux_d)`` for
    an MoE trunk; until decoder training is ported the step raises rather
    than leave the term out."""
    cfg = get_config(arch).SMOKE
    with pytest.raises(NotImplementedError, match="12b"):
        if build == "train_step":
            steps.build_lsr_train_step(cfg)
        else:
            steps.lsr_loss(cfg)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(MOE) + list(ALIASES))
def test_serve_cli_serves_an_moe_id_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--corpus", "48",
                       "--requests", "6", "--method", "fused"]) == 0
    out = capsys.readouterr().out
    assert "encoded 6/6 requests" in out
    assert "retrieval[fused]: top-10 for 6 queries" in out
