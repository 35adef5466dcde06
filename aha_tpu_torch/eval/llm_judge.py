"""LLM-judge scoring of streaming QA (MAGQA): the port's copy of
``aha_tpu/eval/llm_judge.py``.

``LocalJudge`` is a local decoder judge whose few-shot rubric prompt is
prefilled once into a KV cache and reused by every (question, gold, pred)
judgement. The port's cache is updated in place where JAX threads an
immutable one, so a judgement saves the prefix cache's metadata (four small
index tensors), generates on the cache itself and puts the metadata back:
its writes land in slots past the prefix, which the restored metadata marks
empty, and the prefix's keys and values are never written. Also here: the
MAGQA score matrices, the in-span aggregation, the paper's table row, and the
OpenAI Batch-format converters (``submit_openai_batch`` /
``fetch_openai_batch`` import the ``openai`` client where they are called and
need the network; the local judge needs neither).

The rubric is written for this project (the reference's 1-5 correctness
scale and few-shot structure, not its words); swap ``RUBRIC_SYSTEM`` /
``RUBRIC_SHOTS`` for another judge's prompt.
"""

from __future__ import annotations

import json

import numpy as np

RUBRIC_SYSTEM = (
    "You are grading answers from a video question answering system. Compare each "
    "predicted answer with the ground-truth answer and assign one score:\n"
    "- 5: fully correct; the prediction matches the ground truth and covers all key information.\n"
    "- 4: mostly correct; accurate overall with only minor gaps or small inaccuracies.\n"
    "- 3: partially correct; some correct content but important errors or omissions.\n"
    "- 2: barely correct; only a few correct fragments, largely wrong, irrelevant, or contradictory.\n"
    "- 1: incorrect; the prediction is wrong or unrelated to the question.\n\n"
    "Some graded examples follow:"
)

RUBRIC_SHOTS = [
    ("Question: What happens with the bicycle?\nGround Truth Answer: A rider in a red "
     "jacket lifts the bicycle over a fence and then rides away down the path.\n"
     "Predicted Answer: Someone lifts a bike over a fence and rides off.", "4"),
    ("Question: What is on the table?\nGround Truth Answer: A birthday cake with lit "
     "candles sits on the table next to a stack of plates.\nPredicted Answer: The table "
     "is being cleaned with a cloth.", "1"),
    ("Question: What does the chef do?\nGround Truth Answer: The chef chops onions, "
     "then fries them in a pan until golden.\nPredicted Answer: The chef is frying "
     "something in a pan.", "3"),
    ("Question: What is the current scene?\nGround Truth Answer: A close-up of a vintage "
     "motorcycle on display at an indoor show.\nPredicted Answer: A vintage motorcycle "
     "is displayed indoors at a show.", "5"),
    ("Question: What changed in the room?\nGround Truth Answer: The curtains were opened, "
     "sunlight filled the room, and a cat jumped onto the windowsill.\nPredicted Answer: "
     "A cat is sleeping on the sofa in a dark room.", "2"),
]


def rubric_conversation() -> list[dict]:
    conv = [{"role": "system", "content": RUBRIC_SYSTEM}]
    for user, score in RUBRIC_SHOTS:
        conv.append({"role": "user", "content": user})
        conv.append({"role": "assistant", "content": score})
    return conv


class LocalJudge:
    """Prefix-cached local judge over the port's Qwen2 decoder.

    ``params``: an Aha tree, or a bare decoder tree (Qwen2 params: it gets
    zero score heads, the heads no judgement reads); ``cfg``: an
    ``AhaConfig``, or a ``QwenConfig`` for a bare decoder, which then computes
    in f32 (``AhaConfig(llm=cfg, dtype="float32")``, as JAX wraps it);
    ``tokenizer``: a ``StreamTokenizer`` (chat template, encode / decode). The
    cache has ``window`` slots and no eviction; the engine runs on
    ``device`` (the card unless the caller asks for the CPU), where
    ``params`` must already be."""

    def __init__(self, params: dict, cfg, tokenizer, *, window: int = 4096,
                 max_new_tokens: int = 8, device="cuda"):
        import torch

        from ..config import AhaConfig
        from ..ops.kv_cache import CachePolicy
        from ..streaming.engine import StreamEngine

        if "llm" not in params:      # a bare decoder: zero score heads
            H = cfg.llm.hidden_size if isinstance(cfg, AhaConfig) else cfg.hidden_size
            zeros = lambda n: {"kernel": torch.zeros((H, n), dtype=torch.float32,
                                                     device=device)}
            params = {"llm": params, "heads": {"informative": zeros(2), "relevance": zeros(1),
                                               "uncertainty": zeros(1)}}
        if not isinstance(cfg, AhaConfig):
            cfg = AhaConfig(llm=cfg, dtype="float32")
        cfg = cfg.replace(eos_token_id=tokenizer.eos_token_id)
        self.tokenizer = tokenizer
        self.engine = StreamEngine(params, cfg, CachePolicy(kind="none", window=window),
                                   device=device, max_new_tokens=max_new_tokens)
        self.prompt_ids = tokenizer.apply_chat_template(rubric_conversation())
        self.prefix_cache = self.engine.new_cache()
        self.engine.append_ids(self.prefix_cache, [self.prompt_ids])

    def judgement_ids(self, question: str, gold_answer: str, pred_answer: str) -> list[int]:
        """The ids appended after the cached rubric: the user turn and the
        generation prompt."""
        content = (f"Question: {question}\nGround Truth Answer: {gold_answer}\n"
                   f"Predicted Answer: {pred_answer}")
        return self.tokenizer.apply_chat_template([{"role": "user", "content": content}],
                                                  add_generation_prompt=True)

    def generate(self, ids: list[int]) -> list[int]:
        """Greedy ids after the rubric and ``ids``, the prefix cache left as it
        was (its metadata saved and put back; see the module docstring)."""
        c = self.prefix_cache
        meta = [t.clone() for t in (c.key_pos, c.order, c.seen, c.length)]
        try:
            out_ids, out_len, _, _ = self.engine.generate(c, [ids], self.engine.new_rep_counts())
        finally:
            for dst, src in zip((c.key_pos, c.order, c.seen, c.length), meta):
                dst.copy_(src)
        return out_ids[0, :int(out_len[0])].tolist()

    def evaluate(self, question: str, gold_answer: str, pred_answer: str) -> int:
        out = self.generate(self.judgement_ids(question, gold_answer, pred_answer))
        text = self.tokenizer.decode(np.asarray(out), skip_special_tokens=True).strip()
        return int(text[0]) if text and text[0] in "12345" else 1


# ---------------------------------------------------------------------------
# MAGQA score matrices + in-span aggregation
# ---------------------------------------------------------------------------


def magqa_score_matrices(
    pred_examples: list[dict],
    gold_examples: list[dict],
    evaluator,
    *,
    concat_pred_list: bool = False,
) -> list[dict]:
    """Per-example (gold x pred) judge-score matrices; only pairs whose pred
    time falls in the gold span are judged (ref evaluate.py:352-381)."""
    gold_dict = {e["question_id"]: e for e in gold_examples}
    out = []
    for example in pred_examples:
        example = dict(example)
        example.pop("debug_data", None)
        answers = [e for e in example.get("model_response_list", [])
                   if e["role"] == "assistant"]
        if not answers:
            continue
        pred_list = [e["content"] for e in answers]
        pred_times = [e["time"] for e in answers]
        if concat_pred_list:
            seen, dedup = set(), []
            for p in pred_list:
                k = p.lower().strip()
                if k not in seen:
                    seen.add(k)
                    dedup.append(p)
            pred_list = [" ".join(dedup)]
            pred_times = [pred_times[0]]

        gold = gold_dict[example["question_id"]]
        gold_list = [e["content"] for e in gold["answer"]]
        gold_spans = [e["time"] for e in gold["answer"]]
        question = gold["conversation"][0]["content"]

        # dedup identical turns: judge once per unique (gold, pred) text pair
        pred_groups: dict[str, list[int]] = {}
        for i, t in enumerate(pred_list):
            pred_groups.setdefault(t, []).append(i)
        gold_groups: dict[str, list[int]] = {}
        for i, t in enumerate(gold_list):
            gold_groups.setdefault(t, []).append(i)

        matrix = np.ones((len(gold_list), len(pred_list)))
        for gold_text, g_ids in gold_groups.items():
            for pred_text, p_ids in pred_groups.items():
                spans = [gold_spans[i] for i in g_ids]
                times = [pred_times[i] for i in p_ids]
                in_span = [
                    (t == -1 or span[0] <= t <= span[1]) for span in spans for t in times
                ]
                if not any(in_span):
                    continue
                score = evaluator.evaluate(question, gold_text, pred_text)
                rows, cols = np.meshgrid(g_ids, p_ids)
                matrix[rows.flatten(), cols.flatten()] = score
        example["evaluator_output"] = matrix.tolist()
        example["answer"] = gold_list
        example["answer_time"] = gold_spans
        out.append(example)
    return out


def text_score_to_int(text) -> int:
    if not isinstance(text, str):
        return text
    return int(text[0]) if text[0] in "12345" else 1


def analyze_magqa(
    eval_examples: list[dict],
    *,
    num_examples: int = 2000,
    baseline_all_match: bool = True,
    pad_with_one: bool = True,
) -> dict:
    """In-span LLM score + turn statistics (ref analyze_magqa_results.py)."""
    num_turns, num_turns_dedup = [], []
    in_span_scores, max_scores = [], []
    for ex in eval_examples[:num_examples]:
        if not baseline_all_match and ex["model_response_list"][0]["time"] == -1:
            continue
        sentences = [t["content"] for t in ex["model_response_list"]
                     if t["role"] == "assistant"]
        num_turns.append(len(sentences))
        num_turns_dedup.append(len(set(sentences)))
        max_scores.append(np.mean(
            [max(text_score_to_int(s) for s in row) for row in ex["evaluator_output"]]))
        turn_times = [t["time"] for t in ex["model_response_list"]
                      if t["role"] == "assistant"]
        per_gold = []
        for row, span in zip(ex["evaluator_output"], ex["answer_time"]):
            idx = [i for i, t in enumerate(turn_times)
                   if (span[0] <= t <= span[1]) or (baseline_all_match and t == -1)]
            if not idx:
                per_gold.append(1)
            else:
                per_gold.append(np.mean([text_score_to_int(row[i]) for i in idx]))
        in_span_scores.append(np.mean(per_gold) if per_gold else 1)
    if pad_with_one and len(num_turns) < num_examples:
        pad = num_examples - len(num_turns)
        num_turns += [0] * pad
        num_turns_dedup += [0] * pad
        max_scores += [1] * pad
        in_span_scores += [1] * pad
    return {
        "in_span_score": float(np.mean(in_span_scores)),
        "max_score": float(np.mean(max_scores)),
        "turns": float(np.mean(num_turns)),
        "turns_dedup": float(np.mean(num_turns_dedup)),
        "n": len(num_turns),
    }


def format_latex_row(result: dict) -> str:
    """The reference's paper-table row format (analyze_magqa_results.py:69-72):
    `score & turns/turns(dedup.) & \\\\`."""
    return (f"{round(result['in_span_score'], 2)} & "
            f"{round(result['turns'], 2)}/{round(result['turns_dedup'], 2)} & \\\\")


# ---------------------------------------------------------------------------
# OpenAI Batch-format conversion (offline halves; submission gated)
# ---------------------------------------------------------------------------


def to_openai_batch_input(pred_examples, gold_examples, *, model: str = "gpt-4o-mini") -> list[dict]:
    """Pred/gold pairs -> Batch API request lines (ref openai_batch.py:31-106).
    custom_id encodes (question_id, gold turn, pred turn) for reassembly."""
    gold_dict = {e["question_id"]: e for e in gold_examples}
    requests = []
    for example in pred_examples:
        gold = gold_dict[example["question_id"]]
        question = gold["conversation"][0]["content"]
        answers = [e for e in example.get("model_response_list", [])
                   if e["role"] == "assistant"]
        for gi, gold_turn in enumerate(gold["answer"]):
            for pi, pred_turn in enumerate(answers):
                t = pred_turn["time"]
                span = gold_turn["time"]
                if not (t == -1 or span[0] <= t <= span[1]):
                    continue
                content = (f"Question: {question}\nGround Truth Answer: "
                           f"{gold_turn['content']}\nPredicted Answer: {pred_turn['content']}")
                messages = [{"role": "system", "content": RUBRIC_SYSTEM}]
                for user, score in RUBRIC_SHOTS:
                    messages += [{"role": "user", "content": user},
                                 {"role": "assistant", "content": score}]
                messages.append({"role": "user", "content": content})
                requests.append({
                    "custom_id": f"{example['question_id']}|{gi}|{pi}",
                    "method": "POST",
                    "url": "/v1/chat/completions",
                    "body": {"model": model, "messages": messages, "max_tokens": 8},
                })
    return requests


def write_batch_input(requests: list[dict], path: str) -> str:
    """Serialize Batch API request lines to a jsonl file."""
    with open(path, "w") as f:
        for r in requests:
            f.write(json.dumps(r) + "\n")
    return path


def submit_openai_batch(batch_input_path: str, description: str = "aha-magqa-judge"):
    """Upload + submit a Batch API job (ref openai_send_batch,
    openai_batch.py:178-197). Requires the openai client + OPENAI_API_KEY;
    zero-egress environments use LocalJudge instead."""
    from openai import OpenAI  # gated: optional dependency + network

    client = OpenAI()
    with open(batch_input_path, "rb") as f:
        batch_file = client.files.create(file=f, purpose="batch")
    return client.batches.create(
        input_file_id=batch_file.id,
        endpoint="/v1/chat/completions",
        completion_window="24h",
        metadata={"description": description},
    )


def fetch_openai_batch(output_file_id: str, output_path: str) -> list[dict]:
    """Download Batch API results to jsonl + parsed lines (ref
    openai_get_batch, openai_batch.py:253+)."""
    from openai import OpenAI

    client = OpenAI()
    content = client.files.content(output_file_id).text
    with open(output_path, "w") as f:
        f.write(content)
    return [json.loads(l) for l in content.splitlines() if l.strip()]


def from_openai_batch_output(lines: list[dict], pred_examples, gold_examples) -> list[dict]:
    """Batch API responses -> eval-example format with score matrices."""
    gold_dict = {e["question_id"]: e for e in gold_examples}
    scores: dict = {}
    for line in lines:
        qid, gi, pi = line["custom_id"].rsplit("|", 2)
        text = line["response"]["body"]["choices"][0]["message"]["content"]
        scores[(qid, int(gi), int(pi))] = text_score_to_int(text.strip())
    out = []
    for example in pred_examples:
        example = dict(example)
        qid = example["question_id"]
        gold = gold_dict[qid]
        answers = [e for e in example.get("model_response_list", [])
                   if e["role"] == "assistant"]
        matrix = np.ones((len(gold["answer"]), len(answers)))
        for (q, gi, pi), s in scores.items():
            if q == str(qid) or q == qid:
                matrix[gi, pi] = s
        example["evaluator_output"] = matrix.tolist()
        example["answer"] = [t["content"] for t in gold["answer"]]
        example["answer_time"] = [t["time"] for t in gold["answer"]]
        out.append(example)
    return out
