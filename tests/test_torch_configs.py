"""The port's config data equals the JAX package's, field by field, for the
ten archs and their reduced forms; ``count_params`` on the meta device
equals the JAX package's for the dense attention archs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfgs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ARCHS = jcfgs.list_archs()
DENSE = ["qwen2-72b", "deepseek-coder-33b", "qwen2-0.5b", "starcoder2-3b",
         "pixtral-12b"]


def test_registry_matches():
    assert tcfgs.list_archs() == ARCHS and len(ARCHS) == 10
    assert tcfgs.SHAPES == jcfgs.SHAPES
    assert tcfgs.GCN_DATASETS == jcfgs.GCN_DATASETS
    assert [f.name for f in dataclasses.fields(ttr.ModelConfig)] == [
        f.name for f in dataclasses.fields(jtr.ModelConfig)]
    for cls in ("MoEConfig", "EncoderConfig", "ModelConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jtr, cls))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(ttr, cls))}
        assert tf == jf, cls


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match(arch, reduced):
    get_j = jcfgs.get_reduced_config if reduced else jcfgs.get_config
    get_t = tcfgs.get_reduced_config if reduced else tcfgs.get_config
    jc, tc = get_j(arch), get_t(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.head_dim, tc.rnn_width, tc.sub_quadratic) == (
        jc.head_dim, jc.rnn_width, jc.sub_quadratic)
    assert tuple(tc.attn_dims(tc.window)) == tuple(jc.attn_dims(jc.window))
    for shape in tcfgs.SHAPES:
        assert tcfgs.cell_supported(tc, shape) == jcfgs.cell_supported(jc, shape)


@pytest.mark.parametrize("arch", DENSE)
def test_count_params_matches_on_meta(arch):
    assert ttr.count_params(tcfgs.get_config(arch)) == jtr.count_params(
        jcfgs.get_config(arch))
