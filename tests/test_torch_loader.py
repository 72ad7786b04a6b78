"""The port's host loader and the train CLI's regularizer flags against
the JAX package (CPU).

* ``HostShardedLoader`` yields the JAX loader's batches, in the same
  order, as tensors with identical values; ``length_bucket`` returns the
  JAX one's buckets.
* ``--lambda-q``, ``--lambda-d`` and ``--l1-weight`` replace the config's
  field only when given, and move the first loss as the JAX CLI's do:
  the port's loop from the JAX CLI's SMOKE state at the same flags gives
  the JAX CLI's printed first loss within rtol 2e-2 (bf16 compute, as
  ``test_torch_train.py`` holds the CLI), where each flag moves that
  loss by more than ten times the tolerance.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.data import loader as jax_loader
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.data import synthetic
from repro_torch.data.loader import HostShardedLoader, length_bucket
from repro_torch.launch.train import (config_from_args, make_runner,
                                     pair_loader, parser)
from repro_torch.weights import state_from_jax


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2)])
def test_loader_yields_the_jax_loaders_batches_in_order(shard, n_shards):
    kw = dict(batch=3, q_len=7, d_len=11, vocab=300)

    def ours(s, n):
        return synthetic.lsr_pair_batches(shard=s, **kw)

    def theirs(s, n):
        return jax_data.lsr_pair_batches(shard=s, **kw)

    a = HostShardedLoader(ours, shard=shard, n_shards=n_shards)
    b = jax_loader.HostShardedLoader(theirs, shard=shard, n_shards=n_shards)
    try:
        assert (a.shard, a.n_shards) == (b.shard, b.n_shards)
        for _ in range(5):
            got, want = next(a), next(b)
            assert sorted(got) == sorted(want)
            for key in want:
                assert isinstance(got[key], torch.Tensor)
                assert got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(), want[key])
    finally:
        a.close()
        b.close()


def _counting(n, fail_at=None):
    def make_iter(shard, n_shards):
        for i in range(n):
            if i == fail_at:
                raise RuntimeError(f"bad batch {i}")
            yield {"i": np.array([i, shard, n_shards])}
    return make_iter


def test_loader_keeps_order_ends_and_prefetches():
    loader = HostShardedLoader(_counting(7), shard=2, n_shards=3,
                               prefetch=1)
    got = [b["i"].tolist() for b in loader]
    assert got == [[i, 2, 3] for i in range(7)]
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()


def test_loader_raises_the_iterators_error_in_the_consumer():
    with HostShardedLoader(_counting(5, fail_at=3)) as loader:
        assert [int(next(loader)["i"][0]) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(RuntimeError, match="bad batch 3"):
            next(loader)


def test_close_stops_the_prefetch_thread():
    loader = HostShardedLoader(_counting(10**9), prefetch=2)
    next(loader)
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


@pytest.mark.parametrize("seed", range(3))
def test_length_bucket_equals_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 70, size=40).tolist()
    bounds = sorted(rng.choice(64, size=4, replace=False).tolist())
    assert length_bucket(lengths, bounds) == \
        jax_loader.length_bucket(lengths, bounds)
    assert length_bucket([], bounds) == jax_loader.length_bucket([], bounds)
    assert length_bucket(lengths, []) == jax_loader.length_bucket(lengths,
                                                                  [])


CLI = ["--arch", "splade_bert", "--steps", "1", "--batch", "2",
       "--seq-len", "16"]
FLAGS = {"lambda_q": ["--lambda-q", "0.05"],
         "lambda_d": ["--lambda-d", "0.05"],
         "l1_weight": ["--l1-weight", "0.02"]}


def test_regularizer_flags_replace_only_what_is_given():
    base = config_from_args(parser().parse_args(CLI))
    assert base == SMOKE
    cfg = config_from_args(parser().parse_args(CLI + FLAGS["lambda_d"]))
    assert cfg == dataclasses.replace(SMOKE, lambda_d=0.05)
    both = config_from_args(parser().parse_args(
        CLI + FLAGS["lambda_q"] + FLAGS["l1_weight"] + ["--full"]))
    assert (both.lambda_q, both.lambda_d, both.l1_weight) == (
        0.05, both.lambda_d, 0.02)
    assert both.name == "splade-bert" and both.lambda_d == 3e-4


def _jax_first_loss(flags, tmp_path, capsys):
    from repro.launch.train import main as jax_main

    assert jax_main(CLI + flags + ["--ckpt-dir", str(tmp_path)]) == 0
    return float(re.search(r"\(first ([-0-9.e]+)\)",
                           capsys.readouterr().out).group(1))


def _port_first_loss(flags, ckpt_dir):
    """The CLI's loop (its runner, on its loader) from the JAX CLI's
    SMOKE state at ``flags``: the first step's loss."""
    state, _ = jax_steps.init_state("splade_bert", jax.random.PRNGKey(0),
                                    smoke=True)
    cfg = config_from_args(parser().parse_args(CLI + flags))
    state = state_from_jax(jax.tree.map(np.asarray, state), cfg, "cpu")
    cpu = torch.device("cpu")
    with pair_loader(cfg, batch=2, seq_len=16, device=cpu) as loader:
        runner = make_runner(cfg, state, iter(loader), steps=1, lr=2e-4,
                             device=cpu, ckpt_dir=str(ckpt_dir))
        runner.run()
    assert runner.errors == [] and runner.skipped_steps == []
    return float(runner.metrics_log[0]["loss"])


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_regularizer_flags_move_the_loss_as_the_jax_cli(flag, tmp_path,
                                                        capsys):
    base = _jax_first_loss([], tmp_path / "base", capsys)
    want = _jax_first_loss(FLAGS[flag], tmp_path / "flag", capsys)
    assert abs(want - base) > 10 * 2e-2 * abs(want)
    np.testing.assert_allclose(_port_first_loss(FLAGS[flag],
                                                tmp_path / "port"), want,
                               rtol=2e-2)
