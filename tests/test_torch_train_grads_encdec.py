"""The training loss and every parameter's gradient of the encoder
families — whisper's encoder-decoder and llama-3.2-vision's
cross-attention — against the reference's ``jax.value_and_grad`` in
float32 (``test_torch_train_grads`` says how), with each package's stub
frames / patches."""

import pytest

from test_torch_train_grads import check_family_grads


@pytest.mark.parametrize("name", ["whisper-base", "llama-3.2-vision-11b"])
def test_float32_loss_and_grads_match_reference(name, monkeypatch):
    check_family_grads(name, monkeypatch)
