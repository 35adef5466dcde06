"""The MAGQA judge of the port (aha_tpu_torch/eval/llm_judge.py) against the
JAX package on the CPU: the rubric, the score matrices with a fake evaluator,
the in-span analysis, the paper's table row, the OpenAI Batch round trip and
``text_score_to_int`` bit for bit; and ``LocalJudge`` at the tiny preset
(``aha_tiny(vocab_size=256)``, the char tokenizer, f32) against JAX's judge
on the bridged tree: the rubric prompt's ids, each judgement's ids, the
generated ids and the score equal for several (question, gold, pred)
triples, and the prefix cache's metadata and its prefix's keys and values
unchanged by every call."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from aha_tpu.config import aha_tiny
from aha_tpu.eval import llm_judge as jjudge
from aha_tpu.models import aha as jaha

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.eval import llm_judge
from aha_tpu_torch.tokenization import build_stream_tokenizer

params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rubric_matches_jax():
    assert llm_judge.RUBRIC_SYSTEM == jjudge.RUBRIC_SYSTEM
    assert llm_judge.RUBRIC_SHOTS == jjudge.RUBRIC_SHOTS
    assert llm_judge.rubric_conversation() == jjudge.rubric_conversation()


def _examples():
    """Three questions, each with three gold turns (spans) and three
    responses, one at t = -1 (the baseline's all-match time) and repeated
    texts (judged once per unique pair)."""
    preds, golds = [], []
    for q in range(3):
        golds.append({"question_id": f"q{q}",
                      "conversation": [{"role": "user", "content": f"what happens {q}?"}],
                      "answer": [{"content": f"gold {q} {g}", "time": [4 * g, 4 * g + 3]}
                                 for g in range(3)] + ([{"content": f"gold {q} 0",
                                                         "time": [20, 22]}] if q == 1 else [])})
        turns = [{"role": "user", "content": f"what happens {q}?", "time": 0}]
        for i, t in enumerate((1.0, 5.5 if q != 2 else -1, 9.0)):
            turns.append({"role": "assistant", "time": t,
                          "content": f"answer {q} {i % 2}" if q != 0 else f"answer {q} {i}"})
        preds.append({"question_id": f"q{q}", "model_response_list": turns,
                      "debug_data": [{"time": 0.0}]})
    preds.append({"question_id": "q0", "model_response_list": [
        {"role": "user", "content": "x", "time": 0}]})                 # no answers: skipped
    return preds, golds


class FakeJudge:
    """A deterministic evaluator: a score from the texts, and a log of calls."""

    def __init__(self):
        self.calls = []

    def evaluate(self, question, gold, pred):
        self.calls.append((question, gold, pred))
        return 1 + sum(map(ord, question + gold + pred)) % 5


@pytest.mark.parametrize("concat", [False, True])
def test_score_matrices_and_analysis_match_jax(concat):
    preds, golds = _examples()
    a, b = FakeJudge(), FakeJudge()
    got = llm_judge.magqa_score_matrices(preds, golds, a, concat_pred_list=concat)
    ref = jjudge.magqa_score_matrices(preds, golds, b, concat_pred_list=concat)
    assert got == ref and a.calls == b.calls and len(got) == 3
    assert json.dumps(got) == json.dumps(ref)
    if concat:      # one concatenated column: the analysis reads per-turn columns
        return
    for kw in ({}, {"num_examples": 2}, {"baseline_all_match": False},
               {"pad_with_one": False}, {"num_examples": 10, "pad_with_one": True}):
        res = llm_judge.analyze_magqa(got, **kw)
        assert res == jjudge.analyze_magqa(ref, **kw)
        assert llm_judge.format_latex_row(res) == jjudge.format_latex_row(res)


def test_text_score_to_int_matches_jax():
    for x in ("5", "3 - partly", "x", "0", "12", 4, 2.0):
        assert llm_judge.text_score_to_int(x) == jjudge.text_score_to_int(x)


def test_openai_batch_round_trip_matches_jax(tmp_path):
    preds, golds = _examples()
    preds = preds[:3]                  # the examples that have answers
    reqs = llm_judge.to_openai_batch_input(preds, golds, model="m")
    assert reqs == jjudge.to_openai_batch_input(preds, golds, model="m") and reqs
    path = llm_judge.write_batch_input(reqs, str(tmp_path / "in.jsonl"))
    assert [json.loads(x) for x in open(path)] == reqs
    lines = [{"custom_id": r["custom_id"], "response": {"body": {"choices": [
        {"message": {"content": str(1 + i % 5) + " points"}}]}}} for i, r in enumerate(reqs)]
    got = llm_judge.from_openai_batch_output(lines, preds, golds)
    assert got == jjudge.from_openai_batch_output(lines, preds, golds)
    assert callable(llm_judge.submit_openai_batch) and callable(llm_judge.fetch_openai_batch)


# -- LocalJudge at tiny ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def judges():
    """JAX's tiny judge (seed-0 model, vocab 256, char tokenizer) and the
    port's on the bridged tree."""
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(vocab_size=256), seed=0)
    jj = jjudge.LocalJudge(params, cfg, tok)
    d = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    d["llm"] = tconfig.QwenConfig(**cfg.llm.__dict__)
    d["vision"] = tconfig.SiglipConfig(**cfg.vision.__dict__)
    tcfg = tconfig.AhaConfig(**d)
    ttok = build_stream_tokenizer(None, frame_num_tokens=tcfg.frame_num_tokens,
                                  vocab_size=tcfg.llm.vocab_size)
    tj = llm_judge.LocalJudge(params_from_jax(jax.tree.map(np.asarray, params)), tcfg, ttok,
                              device="cpu")
    return jj, tj, tok


TRIPLES = [("what?", "a dog", "a dog"), ("what?", "a cat", "a dog"),
           ("What is the person doing?", "The chef chops onions.", "Someone cooks."),
           ("Where?", "In a garden by the road.", "outside")]


def _snapshot(cache, n: int):
    return ([t.clone() for t in (cache.key_pos, cache.order, cache.seen, cache.length)],
            cache.k[:, :, :n].clone(), cache.v[:, :, :n].clone())


@pytest.mark.parametrize("triple", range(len(TRIPLES)))
def test_local_judge_matches_jax(judges, triple):
    jj, tj, tok = judges
    q, g, p = TRIPLES[triple]
    assert tj.prompt_ids == tok.apply_chat_template(jjudge.rubric_conversation())
    n = len(tj.prompt_ids)
    assert int(tj.prefix_cache.length[0]) == int(jj.prefix_cache.length[0]) == n > 1000
    ids = tj.judgement_ids(q, g, p)
    content = f"Question: {q}\nGround Truth Answer: {g}\nPredicted Answer: {p}"
    assert ids == tok.apply_chat_template([{"role": "user", "content": content}],
                                          add_generation_prompt=True)
    _, out_ids, out_len, _, _ = jj.engine.generate(jj.prefix_cache, [ids],
                                                   jj.engine.new_rep_counts())
    ref = np.asarray(out_ids[0, :int(out_len[0])]).tolist()
    before = _snapshot(tj.prefix_cache, n)
    assert tj.generate(ids) == ref and ref
    assert tj.evaluate(q, g, p) == jj.evaluate(q, g, p)
    after = _snapshot(tj.prefix_cache, n)
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert torch.equal(before[1], after[1]) and torch.equal(before[2], after[2])
    assert int(tj.prefix_cache.length[0]) == n
