"""K1's path rule and the semantics its "tma" path relies on, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds every
path against the plain version there; the C entry works out the launch
geometry). What is decided in Python is held here: ``_plan`` sends every
bf16 input with ``D % 8 == 0`` and 16-byte aligned bases to "tma" (the
main path's shapes among them) and only the others to "wmma"; the
wrapper's checks run before the device check. Beside them, the plain
version against the JAX oracle on exact ties (small-integer inputs whose
logits are exact in f32, with rows of H copied to later positions, so
that the first copy must win), and on masks that empty whole 128-row
chunks, as padded batches do: a masked position never changes ``(y,
i_max)``, so K1's bound counts only the kept ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import sparton_forward_ref as jax_ref
from repro_torch.kernels import sparton as k1

MAIN_SHAPES = [(64, 16), (16, 32), (384, 256), (320, 512)]   # (B, S)
D, V = 768, 30522


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _unaligned(shape, dtype=torch.bfloat16):
    """A CPU tensor whose base lies one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("B,S", MAIN_SHAPES)
def test_plan_sends_the_main_path_to_tma(B, S):
    assert k1._plan(_meta((B, S, D)), _meta((V, D))) == "tma"


@pytest.mark.parametrize("which", ["H", "E"])
def test_plan_sends_unaligned_bf16_to_wmma(which):
    H = _unaligned((2, 16, 64)) if which == "H" else torch.zeros(
        (2, 16, 64), dtype=torch.bfloat16)
    E = _unaligned((40, 64)) if which == "E" else torch.zeros(
        (40, 64), dtype=torch.bfloat16)
    assert (H.data_ptr() % 16, E.data_ptr() % 16) != (0, 0)
    assert k1._plan(H, E) == "wmma"


@pytest.mark.parametrize("d", [20, 13, 30, 766])
def test_plan_sends_d_not_a_multiple_of_8_to_wmma(d):
    assert k1._plan(_meta((3, 33, d)), _meta((100, d))) == "wmma"


@pytest.mark.parametrize("d", [8, 24, 64, 768])
def test_plan_sends_f32_to_f32_whatever_d(d):
    assert k1._plan(_meta((3, 33, d), torch.float32),
                    _meta((100, d), torch.float32)) == "f32"
    assert k1._plan(_meta((3, 33, d)), _meta((100, d))) == "tma"


def test_path_counters_start_at_zero_and_cpu_launches_nothing():
    assert tuple(k1.sparton_forward.path_launches) == k1.PATHS
    before = (k1.sparton_forward.launches,
              dict(k1.sparton_forward.path_launches))
    rng = np.random.default_rng(0)
    H = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    E = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    k1.sparton_forward(H.bfloat16(), E.bfloat16(), torch.zeros(16),
                       torch.ones((2, 16), dtype=torch.int32))
    assert (k1.sparton_forward.launches,
            dict(k1.sparton_forward.path_launches)) == before


def test_argument_checks_run_before_the_device_check():
    """Inputs that pass every check reach the device check: meta tensors
    (the dry run) get the kernel's empty outputs and launch nothing; a
    CPU tensor beside meta ones fails it."""
    H, E = _meta((4, 16, D)), _meta((V, D))
    b, mask = _meta((V,), torch.float32), _meta((4, 16), torch.int32)
    before = (k1.sparton_forward.launches,
              dict(k1.sparton_forward.path_launches))
    for y, i_max in (k1.sparton_forward(H, E, b, mask),
                     k1._launch(H, E, b, mask, None, _path="wmma")):
        assert y.is_meta and tuple(y.shape) == (4, V)
        assert (y.dtype, i_max.dtype) == (torch.float32, torch.int32)
        assert tuple(i_max.shape) == (4, V)
    assert (k1.sparton_forward.launches,
            dict(k1.sparton_forward.path_launches)) == before
    with pytest.raises(ValueError, match="one CUDA device"):
        k1.sparton_forward(H, torch.empty((V, D), dtype=torch.bfloat16),
                           b, mask)
    with pytest.raises(ValueError, match="one CUDA device"):
        k1._launch(H, E, b, torch.ones((4, 16), dtype=torch.int32), None,
                   _path="wmma")
    with pytest.raises(ValueError, match="are not"):
        k1.sparton_forward(_meta((4, 16, D + 8)), E, b, mask)
    with pytest.raises(ValueError, match="do not match"):
        k1.sparton_forward(H, E, _meta((V - 1,), torch.float32), mask)
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        k1.sparton_forward(H, _meta((V, D), torch.float32), b, mask)
    with pytest.raises(ValueError, match="softcap"):
        k1.sparton_forward(H, E, b, mask, softcap=-1.0)
    with pytest.raises(ValueError, match="only bf16 inputs may be sent"):
        k1._launch(H, E, b, mask, None, _path="tma")
    with pytest.raises(ValueError, match="only bf16 inputs may be sent"):
        k1._launch(_meta((4, 16, D), torch.float32),
                   _meta((V, D), torch.float32), b, mask, None,
                   _path="wmma")


def _tie_inputs(B, S, distinct, seed):
    """Small-integer H (every row a copy of one of ``distinct`` rows,
    placed at random), E and bias: every logit exact in f32."""
    rng = np.random.default_rng(seed)
    d, v = 64, 300
    rows = (rng.integers(-1, 2, (B, distinct, d))
            * (rng.random((B, distinct, d)) < 0.3)).astype(np.float32)
    pick = rng.integers(0, distinct, (B, S))
    H = np.take_along_axis(rows, pick[:, :, None], 1)
    E = (rng.integers(-1, 2, (v, d))
         * (rng.random((v, d)) < 0.3)).astype(np.float32)
    b = (rng.integers(-4, 5, v) / 4).astype(np.float32)
    mask = (rng.random((B, S)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    mask[-1] = 0
    return H, E, b, mask


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("B,S,distinct", [(3, 300, 24), (4, 40, 6),
                                          (9, 12, 4)])
def test_plain_k1_gives_the_first_copy_on_exact_ties(B, S, distinct,
                                                     softcap):
    H, E, b, mask = _tie_inputs(B, S, distinct, seed=B * S)
    y_ref, i_ref = jax_ref(*(jnp.asarray(a) for a in (H, E, b, mask)),
                           softcap)
    for dtype in (torch.float32, torch.bfloat16):   # exact in bf16 too
        y, i_max = k1.sparton_forward(
            *(torch.from_numpy(a) for a in (H, E)),
            torch.from_numpy(b), torch.from_numpy(mask), softcap=softcap) \
            if dtype == torch.float32 else k1.sparton_forward(
            torch.from_numpy(H).to(dtype), torch.from_numpy(E).to(dtype),
            torch.from_numpy(b), torch.from_numpy(mask), softcap=softcap)
        np.testing.assert_array_equal(i_max.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                                   rtol=1e-6, atol=1e-6)
        assert (i_max[-1] == 0).all() and (y[-1] == 0).all()


# Masks over (4, 300) that empty whole chunks of 128 positions (the "tma"
# kernel's chunks at S >= 128): lengths ending at and just past a chunk's
# edge, a middle chunk masked in some rows only, rows of one cluster pair
# of different lengths, and all but the last position masked.
def _chunk_masks():
    S = 300
    pos = np.arange(S)
    lengths = np.array([128, 129, 256, 1])[:, None]
    middle = np.ones((4, S), np.int32)
    middle[[0, 2], 128:256] = 0
    last = np.zeros((4, S), np.int32)
    last[:, -1] = 1
    split = (pos < np.array([300, 100, 40, 300])[:, None])
    return {"lengths_at_chunk_edges": (pos < lengths).astype(np.int32),
            "middle_chunk_in_some_rows": middle,
            "only_the_last_position": last,
            "pair_rows_split": split.astype(np.int32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("name", sorted(_chunk_masks()))
def test_plain_k1_ignores_masked_chunks(name, softcap, dtype):
    """Against the JAX oracle, i_max exactly (exact logits); and the same
    bits when every masked row of H is replaced by large values."""
    mask = _chunk_masks()[name]
    B, S = mask.shape
    H, E, b, _ = _tie_inputs(B, S, 12, seed=S + len(name))
    y_ref, i_ref = jax_ref(*(jnp.asarray(a) for a in (H, E, b, mask)),
                           softcap)
    noisy = np.where(mask[:, :, None] != 0, H,
                     np.random.default_rng(1).integers(
                         20, 40, H.shape).astype(np.float32))
    outs = [k1.sparton_forward(torch.from_numpy(h).to(dtype),
                               torch.from_numpy(E).to(dtype),
                               torch.from_numpy(b), torch.from_numpy(mask),
                               softcap=softcap) for h in (H, noisy)]
    (y, i_max), (y_n, i_n) = outs
    np.testing.assert_array_equal(i_max.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(y, y_n) and torch.equal(i_max, i_n)
