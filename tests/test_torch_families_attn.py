"""The model tests of ``test_torch_families.py`` for llama-3.2-vision
(cross-attention to patches) and whisper (encoder-decoder).  That file's
docstring gives the tolerances and why.
"""

import pytest

from test_torch_families import (  # noqa: F401  (the shared tests)
    check_sublayers,
    make_pair,
    shared_routing,
    test_bf16_bound_above_reference_sensitivity,
    test_decode_consistency_within_port,
    test_float32_forward_prefill_decode_match_reference,
    test_forward_matches_reference,
    test_from_reference_is_bit_exact,
    test_prefill_and_decode_match_reference,
)
from test_torch_models import reference_flash  # noqa: F401  (fixture)

HERE = ["llama-3.2-vision-11b", "whisper-base"]


@pytest.fixture(scope="module", params=HERE)
def pair(request):
    return make_pair(request.param)


@pytest.mark.parametrize("name", HERE)
def test_sublayers_match_reference(name, reference_flash):  # noqa: F811
    check_sublayers(name)


def test_kv_positions_only_on_unmasked_calls():
    """``attention_fwd`` masks by key index, so ``kv_positions`` (the
    reference's signature) is taken only where no mask reads it: a
    non-causal call without a window; a causal or windowed call with it
    raises instead of dropping it."""
    import torch

    from repro_torch import configs
    from repro_torch.models import layers
    from repro_torch.models.params import materialize

    cfg = configs.reduce_config(configs.get_config("llama-3.2-vision-11b"))
    p = materialize(layers.attention_specs(cfg, cross=True), seed=0, device="cpu")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0)).bfloat16()
    mem = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    pos, kv_pos = torch.arange(5), torch.arange(7)
    want = layers.attention_fwd(p, cfg, x, pos, causal=False, kv_x=mem)
    got = layers.attention_fwd(p, cfg, x, pos, causal=False, kv_x=mem, kv_positions=kv_pos)
    assert torch.equal(got, want)
    for kw in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="kv_positions"):
            layers.attention_fwd(p, cfg, x, pos, kv_x=mem, kv_positions=kv_pos, **kw)
