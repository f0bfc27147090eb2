"""The LM server against the JAX package's: ``BatchedServer.serve`` gives
the reference's tokens for ragged prompts on 2 slots, with the
reference's weights carried across, in float32, for a decoder, the
``vlm``, the ``moe`` (both styles), ``ssm``, ``hybrid`` and ``audio``
(zeros as the stub's frame embeddings) archs (``dtype = param_dtype =
float32``: greedy tokens equal; the logits of every step agree within
atol = rtol = 1e-4, ``tests/test_torch_lm_models.py``); and the CLI on
the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

MAX_NEW = (5, 1, 3, 6, 2)     # the second retires at admission


def requests(module, vocab: int):
    rng = np.random.default_rng(0)
    return [module.Request(rid=i, prompt=rng.integers(
                0, vocab, int(rng.integers(3, 11))).astype(np.int32),
                max_new_tokens=n)
            for i, n in enumerate(MAX_NEW)]


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "llava-next-34b",
                                  "deepseek-moe-16b", "arctic-480b",
                                  "xlstm-125m", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_serve_gives_the_reference_tokens(name):
    ref_config = ref_get_arch(name).smoke_config().replace(
        dtype=jnp.float32, param_dtype=jnp.float32)
    config = get_arch(name).smoke_config().replace(
        dtype=torch.float32, param_dtype=torch.float32)
    ref_server = ref_serve.BatchedServer(ref_config, n_slots=2, max_len=20,
                                         rng_seed=3)
    tree = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                  ref_server.params)
    server = serve.BatchedServer(
        config, interop.lm_params_from_numpy(tree, config, device="cpu"),
        n_slots=2, max_len=20, device="cpu")
    ref_reqs = requests(ref_serve, config.vocab_size)
    reqs = requests(serve, config.vocab_size)
    want = ref_server.serve(ref_reqs)
    got = server.serve(reqs)
    assert got == want
    assert [len(got[i]) for i in range(len(MAX_NEW))] == list(MAX_NEW)
    assert all(r.done for r in reqs)


def test_serve_draws_weights_from_the_seed():
    config = get_arch("olmo-1b").smoke_config()
    a = serve.BatchedServer(config, n_slots=2, max_len=16, rng_seed=5,
                            device="cpu")
    b = serve.BatchedServer(config, n_slots=3, max_len=16, rng_seed=5,
                            device="cpu")
    for name, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[name]), name
    assert a.serve(requests(serve, config.vocab_size)) == \
        b.serve(requests(serve, config.vocab_size))


def test_server_without_a_card_or_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.BatchedServer(get_arch("yi-6b").smoke_config(), n_slots=1)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "xlstm-125m"])
def test_cli_on_the_cpu(capsys, name):
    serve.main(["--arch", name, "--smoke", "--requests", "3",
                "--prompt-len", "5", "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 6 tokens") and \
        out[0].endswith("on cpu")
    assert len(out) == 4
