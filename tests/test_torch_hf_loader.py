"""The port's HuggingFace Llama loader (``models/llama.from_torch`` and
``server/loader._load_transformers``) against the JAX package's, with a
local ``LlamaConfig`` and random weights (as
``tests/test_transformers_loader.py`` builds them), on the CPU.

``from_torch`` must give the JAX converter's tree leaf for leaf (float32,
exact); the loaded predictors the same bfloat16 leaves, config and
``eos_id``; the port's engine in float64 the JAX engine's greedy tokens
(EOS included); and the port's forward the logits of ``LlamaForCausalLM``
(float32 weights within 1e-4; bfloat16 weights to the same argmax, the
JAX test's bar).  ``rope_scaling`` is refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.models import (
    llama as T,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    generation as TG,
)
from research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu_torch.server import (
    loader as tloader,
)
from tpumlops.models import llama as J
from tpumlops.server import loader as jloader
from tpumlops.server.generation import GenerationEngine as JaxEngine

IDS = [[5, 9, 2, 11, 40, 3]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps this module from crowding tests that run
    beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def hf_artifact(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    art = tmp_path_factory.mktemp("artifacts") / "hf-llama"
    art.mkdir()
    (art / "MLmodel").write_text("flavors:\n  transformers:\n    source_model_name: test\n")
    cfg = LlamaConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    model.save_pretrained(art / "model", safe_serialization=False)
    return art, model


@pytest.fixture(scope="module")
def loaded(hf_artifact):
    art, _ = hf_artifact
    return (tloader.load_predictor(str(art), device="cpu", dtype=None),
            jloader.load_predictor(str(art)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_from_torch_matches_the_jax_converter(hf_artifact, loaded):
    _, model = hf_artifact
    cfg = loaded[0].causal_lm["cfg"]
    got = dict(_leaves(T.from_torch(model, cfg)))
    want = dict(_leaves(J.from_torch(model, loaded[1].causal_lm["cfg"])))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert leaf.dtype == torch.float32 and leaf.is_contiguous(), name
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[name]), err_msg=name)
    # A state dict converts the same as the model.
    sd = T.from_torch(model.state_dict(), cfg)
    assert torch.equal(sd["layers"]["down"], got["/layers/down"])


def test_loaded_predictor_matches_the_jax_loader(loaded):
    port, ref = loaded
    assert port.name == ref.name == "llama-generate"
    assert port.causal_lm["eos_id"] == ref.causal_lm["eos_id"] == 2
    assert vars(port.causal_lm["cfg"]) == dict(vars(ref.causal_lm["cfg"]))
    got = dict(_leaves(port.causal_lm["params"]))
    want = dict(_leaves(ref.causal_lm["params"]))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert leaf.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(want[name], np.float32), err_msg=name)


def test_served_greedy_tokens_match_the_jax_loader_in_f64(loaded):
    port, ref = loaded
    prompts = [([5, 9, 2], 12), ([7, 1, 4, 8, 3, 30, 31], 10), ([42], 14)]
    jeng = JaxEngine(ref.causal_lm["params"], ref.causal_lm["cfg"], max_slots=2,
                     dtype=jnp.float64, eos_id=ref.causal_lm["eos_id"])
    jeng.start(warmup=False)
    try:
        want = [jeng.generate(p, n).tolist() for p, n in prompts]
    finally:
        jeng.shutdown()
    teng = TG.GenerationEngine(port.causal_lm["params"], port.causal_lm["cfg"],
                               max_slots=2, dtype=torch.float64, device="cpu",
                               eos_id=port.causal_lm["eos_id"])
    teng.start()
    try:
        got = [teng.generate(p, n).tolist() for p, n in prompts]
    finally:
        teng.shutdown()
    assert got == want


def test_logits_match_llama_for_causal_lm(hf_artifact, loaded):
    _, model = hf_artifact
    cfg = loaded[0].causal_lm["cfg"]
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(IDS)).logits
    f32, _ = T.prefill(T.from_torch(model, cfg), torch.tensor(IDS), cfg, torch.float32)
    torch.testing.assert_close(f32, ref, rtol=1e-4, atol=1e-4)
    bf16, _ = T.prefill(loaded[0].causal_lm["params"], torch.tensor(IDS), cfg, torch.float32)
    assert (bf16[0].argmax(-1) == ref[0].argmax(-1)).float().mean() == 1.0


def test_quantize_applies_to_an_hf_checkpoint(hf_artifact):
    art, _ = hf_artifact
    pred = tloader.load_predictor(str(art), quantize="int8kv", device="cpu")
    layers = pred.causal_lm["params"]["layers"]
    assert layers["q"]["q8"].dtype == torch.int8 and layers["q"]["scale"].dtype == torch.float32
    assert pred.causal_lm["params"]["embed"].dtype == torch.bfloat16


def _fake_checkpoint(tmp_path, **hf_cfg):
    art = tmp_path / "ckpt"
    art.mkdir()
    (art / "config.json").write_text(json.dumps(hf_cfg))
    (art / "pytorch_model.bin").write_bytes(b"")
    return art


@pytest.mark.parametrize("hf_cfg,needle", [
    ({"model_type": "llama", "rope_scaling": {"rope_type": "llama3", "factor": 8.0}},
     "rope_scaling"),
    ({"model_type": "gpt2"}, "model_type"),
    ({"model_type": "bert", "hidden_act": "relu"}, "hidden_act"),
])
def test_refused_checkpoints(tmp_path, hf_cfg, needle):
    art = _fake_checkpoint(tmp_path, **hf_cfg)
    with pytest.raises(tloader.ModelLoadError, match=needle):
        tloader.load_predictor(str(art), device="cpu")


def test_checkpoint_probe(tmp_path):
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    (sharded / "config.json").write_text(json.dumps({"model_type": "llama"}))
    (sharded / "model.safetensors.index.json").write_text("{}")
    assert tloader._find_hf_checkpoint(sharded) == sharded
    assert tloader._find_hf_checkpoint(tmp_path) == sharded  # a subdirectory
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_text(json.dumps({"flavor": "llama-generate"}))
    assert tloader._find_hf_checkpoint(empty) is None
    with pytest.raises(tloader.ModelLoadError, match="not a recognized artifact"):
        tloader.load_predictor(str(empty), device="cpu")


def test_eos_list_takes_its_first_id(hf_artifact, tmp_path):
    art, _ = hf_artifact
    import shutil

    ckpt = tmp_path / "eos"
    shutil.copytree(art / "model", ckpt)
    cfg = json.loads((ckpt / "config.json").read_text())
    cfg["eos_token_id"] = [7, 9]
    (ckpt / "config.json").write_text(json.dumps(cfg))
    assert tloader.load_predictor(str(ckpt), device="cpu").causal_lm["eos_id"] == 7
