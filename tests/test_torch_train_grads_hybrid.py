"""The training loss and every parameter's gradient of jamba-v0.1-52b against the
reference's ``jax.value_and_grad`` in float32 (``test_torch_train_grads``
says how; a file of its own, so that the reference's slow CPU draw and
eager backward run on a worker of their own)."""

from test_torch_train_grads import check_family_grads


def test_float32_loss_and_grads_match_reference(monkeypatch):
    check_family_grads("jamba-v0.1-52b", monkeypatch)
