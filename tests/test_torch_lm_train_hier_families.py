"""The port's hier_ps LM loss gradients (every parameter leaf and the working
table's) against the JAX reference, on the CPU, for the recurrent and
hybrid families: xlstm-1.3b and hymba-1.5b (``tests/test_torch_lm_train_hier.py``
holds the others), 2 microbatches, remat on, with the tolerances
``tests/test_torch_lm_train.py`` states (xlstm's ``mlstm/b_i`` nearly
cancels in this mode: its bf16 tolerance is ``BF16_LOOSE``'s)."""

import pytest

pytest.importorskip("torch")

from test_torch_lm_train import check_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_hier_loss_gradients_match_reference(arch):
    check_grads(arch, embedding_mode="hier_ps")
