"""The port's config copies against the JAX package's, field by field."""
import dataclasses

import pytest

import repro.configs as jc
import repro_torch.configs as tc

ARCHS = jc.list_archs()


def _fields(cfg):
    return [f.name for f in dataclasses.fields(cfg)]


def test_registry_lists_the_same_archs():
    assert tc.list_archs() == ARCHS
    assert [c.name for c in tc.ASSIGNED] == [c.name for c in jc.ASSIGNED]
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_model_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax_field_by_field(arch, smoke):
    get = "smoke_config" if smoke else "get_model_config"
    mine, ref = getattr(tc, get)(arch), getattr(jc, get)(arch)
    assert _fields(mine) == _fields(ref)
    for name in _fields(ref):
        a, b = getattr(mine, name), getattr(ref, name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        else:
            assert a == b, name
    for prop in ("resolved_head_dim", "interleave_period", "attention_free",
                 "subquadratic"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert [tuple(k.value for k in p) for p in mine.pattern] == \
        [tuple(k.value for k in p) for p in ref.pattern]
    assert mine.to_json() == ref.to_json()


def test_overrides_and_shape_config():
    mine = tc.smoke_config("starcoder2-3b").with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256)
    ref = jc.smoke_config("starcoder2-3b").with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256)
    assert mine.to_json() == ref.to_json()
    s = tc.ShapeConfig("decode_32k", seq_len=32768, global_batch=8,
                       step=tc.StepKind.DECODE)
    r = jc.ShapeConfig("decode_32k", seq_len=32768, global_batch=8,
                       step=jc.StepKind.DECODE)
    assert dataclasses.asdict(s) == dataclasses.asdict(r)
    assert [k.value for k in tc.BlockKind] == [k.value for k in jc.BlockKind]
