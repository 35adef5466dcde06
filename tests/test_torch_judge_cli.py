"""``evaluate --func magqa --judge_ckpt DIR`` of the port on the CPU against
JAX's functions composed as JAX's command means to compose them.

JAX's own command passes ``qwen2_7b()`` (a ``QwenConfig``) to its full-model
``load_params``, which reads ``cfg.vision`` and raises ``AttributeError``
before any judging. So the reference here is JAX's pieces in the command's
order: the checkpoint's vocabulary adopted (``_adopt_checkpoint_config``),
``loader._read_state_dict`` + ``convert_qwen2`` in bf16, JAX's
``LocalJudge`` over the bare decoder (f32 compute), ``magqa_score_matrices``
and ``analyze_magqa``. ``DIR`` holds a tiny Qwen2 (``qwen2_7b`` is
monkeypatched to the tiny shape in both packages' ``config`` modules; the
vocabulary, 1,024, comes from the directory's ``config.json``) written with
the port's ``save_safetensors`` in the reference's key layout, and a
byte-level BPE tokenizer trained here. The output lines and the printed
analysis must be equal."""

import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from aha_tpu import config as jconfig
from aha_tpu.cli import _session as jsession
from aha_tpu.cli import evaluate as jcli
from aha_tpu.eval import llm_judge as jjudge
from aha_tpu.models import loader as jloader
from aha_tpu.tokenization import BOS, EOS
from aha_tpu.tokenization import build_stream_tokenizer as jbuild_tokenizer

from aha_tpu_torch import config as tconfig
from aha_tpu_torch.cli import evaluate as tcli
from aha_tpu_torch.models import loader

pytest.importorskip("transformers")
VOCAB = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def judge_dir(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("judge")
    corpus = [jjudge.RUBRIC_SYSTEM] + [u for u, _ in jjudge.RUBRIC_SHOTS] + [
        "Question: what is the person doing? Ground Truth Answer: cooking rice.",
        "Predicted Answer: the person is cooking rice in a pan."] * 10
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=600, special_tokens=[BOS, EOS, "<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token=BOS, eos_token=EOS,
                            pad_token="<|endoftext|>").save_pretrained(str(d))
    # a tiny Qwen2 in the reference's key layout: the port's seeded init, decoder keys only
    cfg = tconfig.aha_tiny(VOCAB)
    tree = loader.init_aha_params(cfg, seed=3, device="cpu")
    sd = {k: v.contiguous() for k, v in loader.export_hf_state_dict(tree, cfg).items()
          if k.startswith(("model.layers.", "model.embed_tokens.", "model.norm.", "lm_head."))}
    loader.save_safetensors(sd, str(d / "model.safetensors"), {"format": "pt"})
    (d / "config.json").write_text(json.dumps({"vocab_size": VOCAB,
                                               "architectures": ["Qwen2ForCausalLM"]}))
    return d


@pytest.fixture
def tiny_qwen(monkeypatch):
    monkeypatch.setattr(jconfig, "qwen2_7b", lambda: jconfig.qwen2_tiny())
    monkeypatch.setattr(tconfig, "qwen2_7b", lambda: tconfig.qwen2_tiny())


def _files(tmp_path):
    """Three questions, three gold spans and three responses each."""
    preds, golds = [], []
    answers = ["someone is cooking", "a dog runs in a garden", "the chef fries onions"]
    for q in range(3):
        golds.append({"question_id": q,
                      "conversation": [{"role": "user", "content": f"What happens in part {q}?"}],
                      "answer": [{"content": answers[(q + g) % 3], "time": [3 * g, 3 * g + 2]}
                                 for g in range(3)]})
        preds.append({"question_id": q, "model_response_list": [
            {"role": "user", "content": f"What happens in part {q}?", "time": 0}] + [
            {"role": "assistant", "content": answers[(q * 2 + i) % 3], "time": 3 * i + 1}
            for i in range(3)], "debug_data": []})
    pred, gold = tmp_path / "pred.jsonl", tmp_path / "gold.json"
    pred.write_text("".join(json.dumps(p) + "\n" for p in preds))
    gold.write_text(json.dumps(golds))
    return pred, gold


def test_cmd_evaluate_magqa_judge_matches_jax_composed(judge_dir, tiny_qwen, tmp_path, capsys):
    pred, gold = _files(tmp_path)
    out = tmp_path / "scored.jsonl"
    tcli.cmd_evaluate(["--func", "magqa", "--pred_file", str(pred), "--gold_file", str(gold),
                       "--judge_ckpt", str(judge_dir), "--output_file", str(out),
                       "--device", "cpu"])
    printed = capsys.readouterr().out
    lines = out.read_text().splitlines()

    # JAX's pieces, composed in the command's order
    cfg = jsession._adopt_checkpoint_config(jconfig.AhaConfig(llm=jconfig.qwen2_7b()),
                                            str(judge_dir)).llm
    assert cfg.vocab_size == VOCAB and not hasattr(jconfig.qwen2_7b(), "vision")
    params = jloader.convert_qwen2(jloader._read_state_dict(str(judge_dir)), cfg,
                                   prefix="model.", dtype=jnp.bfloat16)
    judge = jjudge.LocalJudge(params, cfg, jbuild_tokenizer(str(judge_dir)))
    preds = [json.loads(x) for x in open(pred)]
    scored = jjudge.magqa_score_matrices(preds, json.loads(gold.read_text()), judge)
    assert lines == [json.dumps(ex) for ex in scored] and len(lines) == 3
    assert printed == json.dumps(jjudge.analyze_magqa(scored), indent=2) + "\n"
    assert len(judge.tokenizer.apply_chat_template(jjudge.rubric_conversation())) > 100


def test_jax_judge_command_stops_before_judging(judge_dir, tiny_qwen, tmp_path):
    """The known divergence: JAX's command itself raises AttributeError
    (``cfg.vision`` of a QwenConfig) where the port judges."""
    pred, gold = _files(tmp_path)
    with pytest.raises(AttributeError, match="vision"):
        jcli.cmd_evaluate(["--func", "magqa", "--pred_file", str(pred), "--gold_file",
                           str(gold), "--judge_ckpt", str(judge_dir)])
    assert dataclasses.is_dataclass(tconfig.qwen2_7b())
