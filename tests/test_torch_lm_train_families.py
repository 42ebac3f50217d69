"""The port's dense-embedding LM training step against the JAX reference, on
the CPU: the VLM, hybrid, SSM and audio families (pixtral-12b, hymba-1.5b,
xlstm-1.3b, whisper-tiny), as ``tests/test_torch_lm_train.py`` holds the
transformer families, with its tolerances: the loss within 1e-3 and each
gradient leaf within 5e-2 of its own largest magnitude in bf16, 1e-3 with
fp32 compute; 2 microbatches, remat on. A VLM's image
positions carry no loss; the audio family takes ``frames``."""

import pytest

pytest.importorskip("torch")

from test_torch_lm_train import check_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["pixtral-12b", "hymba-1.5b", "xlstm-1.3b", "whisper-tiny"])
def test_dense_loss_gradients_match_reference(arch):
    check_grads(arch)
