"""Train steps of the moe, ssm, hybrid and audio archs' smoke configs
against the JAX package's ``make_train_step`` (float32 compute, from one
carried-across state; the MoE archs' drops token for token first), as
``tests/test_torch_train_archs.py`` holds the decoders."""
import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402

from test_torch_train_archs import DECODERS, check_train_step  # noqa: E402

FAMILIES = tuple(sorted(set(ARCHS) - set(DECODERS)))


def test_the_families_are_the_other_archs():
    assert FAMILIES == ("arctic-480b", "deepseek-moe-16b",
                        "seamless-m4t-large-v2", "xlstm-125m", "zamba2-2.7b")


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_the_reference(name):
    check_train_step(name)
