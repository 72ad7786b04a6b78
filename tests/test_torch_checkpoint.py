"""The port's checkpoint store against the JAX package's, on the CPU:
every case of ``tests/test_checkpoint.py`` on torch trees, and the two
packages' checkpoints interchangeable bit for bit (a JAX-written train
state loads in the port, a port-written one in JAX, with equal
manifests), also with bf16 params (a decoder's published CONFIG): the
npz entries byte for byte. Arrays are compared exactly: the store casts
nothing."""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tfm
from repro.optim import optimizers as jax_opt
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.launch import steps
from repro_torch.launch.train import make_runner, pair_loader
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers as opt
from repro_torch.weights import state_from_jax

ROOT = Path(__file__).resolve().parents[1]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 3), generator=g),
                   "layers": [torch.ones((2,)), torch.zeros((3,))]},
        "opt": {"mu": {"w": torch.zeros((4, 3))}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(x) for x in tree]
    return torch.zeros_like(tree)


def _assert_equal(a, b):
    for (ka, x), (kb, y) in zip(store._items(a), store._items(b),
                                strict=True):
        assert ka == kb
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, ka
        np.testing.assert_array_equal(x, y)


def test_roundtrip(tmp_path):
    state = _state()
    path = save_checkpoint(str(tmp_path), 7, state)
    assert path and os.path.isdir(path)
    restored, step = load_checkpoint(str(tmp_path), _zeros_like(state))
    assert step == 7
    _assert_equal(state, restored)
    assert isinstance(restored["params"]["layers"], list)


def test_latest_step_and_gc(tmp_path):
    state = _state()
    for s in (10, 20, 30, 40):
        save_checkpoint(str(tmp_path), s, state, keep=2)
    assert latest_step(str(tmp_path)) == 40
    # keep=2: only the last two survive
    steps_left = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                        if d.startswith("step_"))
    assert steps_left == [30, 40]


def test_tmp_dirs_are_not_trusted(tmp_path):
    save_checkpoint(str(tmp_path), 5, _state())
    # a crashed writer leaves a .tmp dir, or one without a manifest
    os.makedirs(tmp_path / "step_000000099.tmp")
    os.makedirs(tmp_path / "step_000000098")
    assert latest_step(str(tmp_path)) == 5


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((3,))})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), {"w": torch.zeros((4,))})


def test_missing_leaf_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((3,))})
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path), {"w": torch.zeros((3,)),
                                        "extra": torch.zeros((2,))})


def test_non_writer_process_skips(tmp_path):
    out = save_checkpoint(str(tmp_path), 1, _state(), process_index=1)
    assert out is None
    assert latest_step(str(tmp_path)) is None


def test_async_checkpointer(tmp_path):
    ckpt = AsyncCheckpointer(str(tmp_path), keep=5)
    state = _state()
    for s in (1, 2, 3):
        ckpt.save(s, state)
    ckpt.close()
    assert latest_step(str(tmp_path)) == 3
    restored, step = load_checkpoint(str(tmp_path), _zeros_like(state))
    assert step == 3
    _assert_equal(state, restored)


def test_async_checkpointer_copies_at_save(tmp_path):
    """The host copy is taken inside save(): a later in-place change of
    the state does not reach the checkpoint."""
    ckpt = AsyncCheckpointer(str(tmp_path))
    state = _state()
    want = state["params"]["w"].clone()
    ckpt.save(1, state)
    state["params"]["w"].add_(1.0)
    ckpt.close()
    restored, _ = load_checkpoint(str(tmp_path), _zeros_like(_state()))
    torch.testing.assert_close(restored["params"]["w"], want, rtol=0, atol=0)


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ckpt = AsyncCheckpointer(str(blocker / "ckpt"))
    ckpt.save(1, _state())
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ckpt.close()


def test_int_leaf_is_int32_on_disk_and_int_again(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"step": 3, "w": torch.ones(2)})
    with np.load(tmp_path / "step_000000003" / "arrays.npz") as z:
        assert z["['step']"].dtype == np.int32 and z["['step']"].shape == ()
    restored, _ = load_checkpoint(str(tmp_path), {"step": 0,
                                                  "w": torch.zeros(2)})
    assert restored["step"] == 3 and type(restored["step"]) is int


def test_bf16_leaf_raises_naming_it(tmp_path):
    """A bf16 leaf is stored as its raw 2-byte values, and loading it into
    a template leaf of another dtype (here f32) raises, naming the leaf:
    nothing is cast."""
    save_checkpoint(str(tmp_path), 1, {"params": {
        "w": torch.ones(2, dtype=torch.bfloat16)}})
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(TypeError, match=r"\['params'\]/\['w'\]"):
        load_checkpoint(str(tmp_path), {"params": {"w": torch.zeros(2)}})


def test_restored_tensors_land_on_the_template_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(3.0)})
    restored, _ = load_checkpoint(str(tmp_path), {
        "w": torch.empty(3, device="meta")})
    assert restored["w"].device.type == "meta"
    assert restored["w"].dtype == torch.float32


_WRITER = """
import sys, torch, torch.distributed as dist
from repro_torch.checkpoint.store import save_checkpoint
rank, pg, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{pg}", world_size=2,
                        rank=rank)
print(save_checkpoint(f"{out}/rank{rank}", 1, {"w": torch.ones(2)}))
dist.barrier()
dist.destroy_process_group()
"""


def test_only_rank_zero_writes_under_a_process_group(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WRITER, str(r), str(tmp_path / "pg"),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[1][0].strip() == "None"
    assert latest_step(str(tmp_path / "rank0")) == 1
    assert latest_step(str(tmp_path / "rank1")) is None


# ---------------------------------------------------------------------------
# the two packages' checkpoints
# ---------------------------------------------------------------------------

def _jax_state():
    """The JAX CLI's SMOKE train state with non-zero moments and the
    step counter at 11."""
    state, _ = jax_steps.init_state("splade_bert", jax.random.PRNGKey(0),
                                    smoke=True)
    bump = jax.tree.map(lambda x: x + 0.25, state["opt"])
    return {**state, "opt": bump, "step": jnp.array(11, jnp.int32)}


def _port_template():
    return steps.init_state("splade_bert", torch.Generator().manual_seed(1),
                            smoke=True)


def _manifest(path):
    with open(Path(path) / "manifest.json") as f:
        return json.load(f)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    j_state = _jax_state()
    jax_store.save_checkpoint(str(tmp_path), 11, j_state)
    restored, step = load_checkpoint(str(tmp_path), _port_template())
    assert step == 11 and restored["step"] == 11
    want = state_from_jax(jax.tree.map(np.asarray, j_state), SMOKE, "cpu")
    _assert_equal({**restored, "step": 11}, {**want, "step": 11})
    for (_, got), leaf in zip(store._items(restored["params"]),
                              jax.tree.leaves(j_state["params"]),
                              strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def test_port_checkpoint_loads_in_jax(tmp_path):
    t_state = state_from_jax(jax.tree.map(np.asarray, _jax_state()), SMOKE,
                             "cpu")
    save_checkpoint(str(tmp_path), 11, t_state)
    template = jax.tree.map(jnp.zeros_like, _jax_state())
    restored, step = jax_store.load_checkpoint(str(tmp_path), template)
    assert step == 11
    assert np.asarray(restored["step"]).dtype == np.int32
    assert int(restored["step"]) == 11
    for (key, got), want in zip(store._items(t_state),
                                jax.tree.leaves(restored), strict=True):
        want = np.asarray(want)
        got = np.asarray(np.int32(got) if isinstance(got, int) else got)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want)


def test_manifests_and_arrays_equal_for_the_same_state(tmp_path):
    j_state = _jax_state()
    t_state = state_from_jax(jax.tree.map(np.asarray, j_state), SMOKE, "cpu")
    j_path = jax_store.save_checkpoint(str(tmp_path / "jax"), 11, j_state,
                                       extra_meta={"arch": "splade_bert"})
    t_path = save_checkpoint(str(tmp_path / "port"), 11, t_state,
                             extra_meta={"arch": "splade_bert"})
    assert _manifest(t_path) == _manifest(j_path)
    assert _manifest(t_path)["treedef"] == str(
        jax.tree_util.tree_structure(j_state))
    with np.load(Path(j_path) / "arrays.npz") as zj, \
            np.load(Path(t_path) / "arrays.npz") as zt:
        assert zj.files == zt.files
        for key in zj.files:
            assert zj[key].dtype == zt[key].dtype, key
            np.testing.assert_array_equal(zj[key], zt[key])


@pytest.mark.parametrize("tree", [
    {"b": [1, (2,)], "a": {"y": 3, "x": (4, 5)}, "c": None},
    {"params": {"layers": [0, 1]}, "step": 0},
    [1, {"k": (2, [3])}],
])
def test_treedef_string_is_jax_s(tree):
    as_arrays = jax.tree.map(np.asarray, tree)
    assert f"PyTreeDef({store._treedef(tree)})" == str(
        jax.tree_util.tree_structure(as_arrays))
    paths = ["/".join(str(p) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(as_arrays)[0]]
    assert [k for k, _ in store._items(tree)] == paths


# ---------------------------------------------------------------------------
# bf16 params (every decoder's published CONFIG)
# ---------------------------------------------------------------------------

def _bf16_cfgs(arch):
    over = {"param_dtype": "bfloat16"}
    return (dataclasses.replace(jax_config(arch).SMOKE, **over),
            dataclasses.replace(get_config(arch).SMOKE, **over))


def _jax_bf16_state(arch):
    """A JAX train state of the arch's SMOKE config at bf16 params: f32
    moments made non-zero, the step counter at 5."""
    cfg_j, _ = _bf16_cfgs(arch)
    params = jax_tfm.init_params(jax.random.PRNGKey(0), cfg_j)
    moments = jax.tree.map(lambda x: x + 0.125,
                           jax_opt.adamw(1e-4).init(params))
    return {"params": params, "opt": moments,
            "step": jnp.array(5, jnp.int32)}


def _port_bf16_template(arch):
    _, cfg = _bf16_cfgs(arch)
    params = tfm.init_params(torch.Generator().manual_seed(1), cfg)
    return {"params": params, "opt": opt.adamw(1e-4).init(params),
            "step": 0}


def _npz_entries(path):
    with zipfile.ZipFile(Path(path) / "arrays.npz") as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("arch", ["llama3_2_3b", "moonshot_v1_16b"])
def test_bf16_state_npz_entries_equal_jax_byte_for_byte(arch, tmp_path):
    """The same bf16-param train state saved by both packages: every npz
    entry (the ``.npy`` header and data) equal byte for byte, the bf16
    leaves' headers saying ``'<V2'``, and equal manifests."""
    j_state = _jax_bf16_state(arch)
    _, cfg = _bf16_cfgs(arch)
    t_state = state_from_jax(jax.tree.map(np.asarray, j_state), cfg, "cpu")
    assert t_state["params"]["embed"].dtype == torch.bfloat16
    assert t_state["opt"]["mu"]["embed"].dtype == torch.float32
    j_path = jax_store.save_checkpoint(str(tmp_path / "jax"), 5, j_state)
    t_path = save_checkpoint(str(tmp_path / "port"), 5, t_state)
    j_entries, t_entries = _npz_entries(j_path), _npz_entries(t_path)
    assert sorted(j_entries) == sorted(t_entries)
    for name, data in j_entries.items():
        assert t_entries[name] == data, name
    embed = t_entries["['params']/['embed'].npy"]
    assert b"'descr': '<V2'" in embed[:128]
    assert _manifest(t_path) == _manifest(j_path)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "moonshot_v1_16b"])
def test_jax_bf16_checkpoint_resumes_in_the_port_with_the_same_bits(
        arch, tmp_path):
    """A JAX-written bf16-param checkpoint loads in the port as bf16 with
    the same bits (and f32 moments). The reference's own loader hands such
    a leaf back as a ``|V2`` void array, not as bf16; the port does not
    copy that."""
    j_state = _jax_bf16_state(arch)
    jax_store.save_checkpoint(str(tmp_path), 5, j_state)
    restored, step = load_checkpoint(str(tmp_path),
                                     _port_bf16_template(arch))
    assert step == 5 and restored["step"] == 5
    n_bf16 = 0
    for (key, got), want in zip(store._items(restored),
                                jax.tree.leaves(j_state), strict=True):
        want = np.asarray(want)
        if isinstance(got, int):
            assert got == int(want), key
            continue
        if want.dtype.name == "bfloat16":
            n_bf16 += 1
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got.dtype == torch.float32, key
            np.testing.assert_array_equal(got.numpy(), want)
    assert n_bf16 == len(jax.tree.leaves(j_state["params"])) - 1  # b: f32
    # the reference's load of the same file: void arrays, not bf16
    jax_loaded, _ = jax_store.load_checkpoint(
        str(tmp_path), jax.tree.map(jnp.zeros_like, j_state))
    assert np.asarray(jax_loaded["params"]["embed"]).dtype == np.dtype("V2")


def test_bf16_decoder_runner_checkpoints_and_resumes(tmp_path):
    """``make_runner`` on the SMOKE llama at bf16 params writes its final
    checkpoint, and a second runner resumes from it (``--resume``'s
    ``try_resume``): the state of step 2 bit for bit, bf16 params, then
    one more step."""
    _, cfg = _bf16_cfgs("llama3_2_3b")
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = torch.device("cpu")
    ckpt = str(tmp_path / "ck")
    with pair_loader(cfg, batch=2, seq_len=8, device=cpu) as loader:
        first = make_runner(cfg, _port_bf16_template("llama3_2_3b"),
                            iter(loader), steps=2, lr=1e-3, device=cpu,
                            ckpt_dir=ckpt)
        state2 = first.run()
    assert first.errors == [] and latest_step(ckpt) == 2
    assert state2["params"]["embed"].dtype == torch.bfloat16
    with pair_loader(cfg, batch=2, seq_len=8, device=cpu) as loader:
        second = make_runner(cfg, _port_bf16_template("llama3_2_3b"),
                             iter(loader), steps=3, lr=1e-3, device=cpu,
                             ckpt_dir=ckpt)
        assert second.try_resume() and second.start_step == 2
        for (key, got), (_, want) in zip(store._items(second.state),
                                         store._items(state2), strict=True):
            if isinstance(want, int):
                assert got == want, key
            else:
                assert got.dtype == want.dtype and torch.equal(got, want), key
        state3 = second.run()
    assert second.errors == [] and state3["step"] == 3
    assert latest_step(ckpt) == 3
    assert state3["params"]["embed"].dtype == torch.bfloat16
    assert not torch.equal(state3["params"]["embed"],
                           state2["params"]["embed"])
