"""The port's LM training against the reference, on the CPU: the hybrid
(jamba-reduced: Mamba and attention with MLP and MoE), VLM
(llama-vision-reduced: XATTN over image tokens) and encoder-decoder
(seamless-reduced) configurations. The cases and bounds are those of
``tests/test_torch_lm_train.py``, whose helpers run them; this file keeps
each of the two under its time budget."""
import pytest
import torch

from test_torch_lm_train import (check_gradients, check_round_trip,
                                 check_step, check_updated_params,
                                 train_case)

ARCHS = ["jamba1_5_large_398b", "llama3_2_vision_90b",
         "seamless_m4t_large_v2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other LM test files. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return train_case(request.param)


def test_train_step_matches_reference(case):
    check_step(case)


def test_gradients_match_reference(case):
    check_gradients(case)


def test_updated_parameters_match_reference(case):
    check_updated_params(case)


def test_train_state_round_trip(case):
    check_round_trip(case)
