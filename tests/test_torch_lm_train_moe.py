"""The port's dense-embedding LM training step against the JAX reference, on
the CPU: nemotron-4-340b and the MoE family (olmoe-1b-7b, phi3.5-moe), as
``tests/test_torch_lm_train.py`` holds the others, with its tolerances: the
loss within 1e-3 and each gradient leaf within 5e-2 of its own largest
magnitude in bf16, 1e-3 with fp32 compute; 2 microbatches, remat on. The
MoE aux loss (coefficient 0.01) carries the router's gradient with the
combine weights."""

import pytest

pytest.importorskip("torch")

from test_torch_lm_train import check_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"])
def test_dense_loss_gradients_match_reference(arch):
    check_grads(arch)
