"""TMemNet in the port against the JAX package, in f32 on the CPU: the
cases of tests/test_torch_baselines.py (see its docstring; the same toy
widths, tolerances and JAX programs) run on "tmemnet", with its own module
fixture. Beside them: the rank (the knowledge attention) with greedy,
beam and rank-only serving within 1e-5, ``ps_train`` (the selection loss
alone; the decoder's gradients zero) and per-row decode positions in the
chunked decode."""

import pytest

from tests import test_torch_baselines as base
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

NAME = "tmemnet"


@pytest.fixture(scope="module")
def models():
    return base.Models()


def test_bridge_maps_every_leaf(models):
    base.test_bridge_maps_every_leaf(models, NAME)


@pytest.mark.parametrize("mode", ["train", "ps_train"])
def test_losses_and_gradients_match_jax(models, mode):
    base.test_losses_and_gradients_match_jax(models, NAME, mode)


@pytest.mark.parametrize("early_exit", [False, True])
def test_greedy_and_rank_match_jax(models, early_exit):
    base.test_greedy_matches_jax(models, NAME, early_exit)


def test_beam_width_3_matches_jax(models):
    base.test_beam_width_3_matches_jax(models, NAME)


def test_sample_top_k_1_is_jax_greedy(models):
    base.test_sample_top_k_1_is_jax_greedy(models, NAME)


def test_chunked_decode_lockstep_matches_jax(models):
    base.test_chunked_decode_lockstep_matches_jax(models, NAME)


def test_sampled_continuous_equals_one_shot(models):
    base.test_sampled_continuous_equals_one_shot(models, NAME)
