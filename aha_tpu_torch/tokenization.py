"""Stream chat template and tokenizer backends.

The port's own copy of what the inference path reads from
``aha_tpu/tokenization.py`` (which reaches for no other module of that
package): the deterministic renderer of the stream chat template with its
three extra prompt modes (``add_stream_prompt``,
``add_stream_query_prompt``, ``add_stream_generation_prompt``), the
character-level tokenizer used by tests and synthetic runs, the wrapper of a
local HuggingFace tokenizer, and ``StreamTokenizer`` /
``build_stream_tokenizer``. The learn-range machinery of the training labels
(``transition_offsets``, ``stream_placeholder_len``, ``get_learn_ranges`` and
the backends' ``encode_with_offsets``) is carried for the data pipeline; the
Jinja rendition of the template is not.

Roles and layout (bos = ``<|im_start|>``, eos = ``<|im_end|>``):

    <|im_start|>system\\nSYS<|im_end|>
    \\n<|im_start|>stream\\n<image>*(num_frames*frame_num_tokens)<|im_end|>
    \\n<|im_start|>user\\nQ<|im_end|>
    \\n<|im_start|>assistant\\nA<|im_end|>
"""

from __future__ import annotations

from dataclasses import dataclass, field

BOS = "<|im_start|>"
EOS = "<|im_end|>"


@dataclass(frozen=True)
class TemplateConfig:
    v_placeholder: str = "<image>"
    frame_num_tokens: int = 49
    bos: str = BOS
    eos: str = EOS


def render_chat(
    conversation: list[dict],
    cfg: TemplateConfig,
    *,
    add_generation_prompt: bool = False,
    add_stream_prompt: bool = False,
    add_stream_query_prompt: bool = False,
    add_stream_generation_prompt: bool = False,
) -> str:
    """Render a conversation to the prompt string. Messages without a
    'role' key are ignored (``[{}]`` yields the bare trailing prompts)."""
    bos, eos = cfg.bos, cfg.eos
    out: list[str] = []
    messages = conversation
    if messages and messages[0].get("role") == "system":
        out.append(f"{bos}system\n{messages[0]['content']}{eos}")
        messages = messages[1:]
    for message in messages:
        role = message.get("role")
        if role == "user":
            if add_stream_query_prompt:
                out.append(f"{eos}\n{bos}user\n{message['content']}{eos}")
            else:
                out.append(f"\n{bos}user\n{message['content']}{eos}")
        elif role == "assistant":
            out.append(f"\n{bos}assistant\n{message['content']}{eos}")
        elif role == "stream" and message.get("num_frames", 0) > 0:
            placeholder = cfg.v_placeholder * (cfg.frame_num_tokens * message["num_frames"])
            out.append(f"\n{bos}stream\n{placeholder}{eos}")
    if add_generation_prompt:
        out.append(f"\n{bos}assistant\n")
    elif add_stream_prompt:
        out.append(f"\n{bos}stream\n")
    elif add_stream_generation_prompt:
        out.append(f"{eos}\n{bos}assistant\n")
    return "".join(out)


def transition_offsets(cfg: TemplateConfig) -> dict:
    """Char length of each role transition of the template."""
    bos, eos = cfg.bos, cfg.eos
    table = {
        (None, "system"): f"{bos}system\n",
        ("system", "user"): f"{eos}\n{bos}user\n",
        ("system", "stream"): f"{eos}\n{bos}stream\n",
        ("user", "assistant"): f"{eos}\n{bos}assistant\n",
        ("user", "stream"): f"{eos}\n{bos}stream\n",
        ("user", "user"): f"{eos}\n{bos}user\n",
        ("assistant", "user"): f"{eos}\n{bos}user\n",
        ("assistant", "stream"): f"{eos}\n{bos}stream\n",
        ("stream", "user"): f"{eos}\n{bos}user\n",
        ("stream", "assistant"): f"{eos}\n{bos}assistant\n",
        ("stream", "stream"): f"{eos}\n{bos}stream\n",
        "assistant": f"{bos}assistant\n",
        "eos_token": eos,
    }
    return {k: len(v) for k, v in table.items()}


def stream_placeholder_len(num_frames: int, cfg: TemplateConfig) -> int:
    return num_frames * cfg.frame_num_tokens * len(cfg.v_placeholder)


def get_learn_ranges(conversation: list[dict], cfg: TemplateConfig) -> list[range]:
    """Char spans of the learned assistant turns of a rendered conversation:
    each covers the assistant's content and its closing eos. Stream turns are
    never learned through the LM loss (the frame-score heads supervise them)."""
    offsets = transition_offsets(cfg)
    offset = 0
    learn_ranges: list[range] = []
    last_role = None
    for message in conversation:
        role = message["role"]
        offset += offsets[(last_role, role)]
        last_role = role
        if role == "stream":
            offset += stream_placeholder_len(message["num_frames"], cfg)
        else:
            if role == "assistant" and message.get("learn", False):
                learn_ranges.append(
                    range(offset, offset + len(message["content"]) + offsets["eos_token"]))
            offset += len(message["content"])
    return learn_ranges


class CharTokenizer:
    """Character-level tokenizer with special-token support. Regular
    characters map to their codepoint (mod ``char_vocab``); special tokens
    occupy fixed ids at the top of the vocab."""

    def __init__(self, vocab_size: int = 512, extra_specials: tuple[str, ...] = ()):
        self.vocab_size = vocab_size
        specials = [BOS, EOS, "<image>", "<pad>", *extra_specials]
        self.special_to_id = {s: vocab_size - len(specials) + i for i, s in enumerate(specials)}
        self.id_to_special = {v: k for k, v in self.special_to_id.items()}
        self.char_vocab = vocab_size - len(specials)
        self.bos_token, self.eos_token = BOS, EOS
        self.bos_token_id = self.special_to_id[BOS]
        self.eos_token_id = self.special_to_id[EOS]
        self.pad_token_id = self.special_to_id["<pad>"]
        # longest-match ordering for the scanner
        self._specials_sorted = sorted(self.special_to_id, key=len, reverse=True)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.special_to_id[token]

    def encode_with_offsets(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        """-> (ids, the (start, stop) char span of each id)."""
        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        i = 0
        n = len(text)
        while i < n:
            for sp in self._specials_sorted:
                if text.startswith(sp, i):
                    ids.append(self.special_to_id[sp])
                    offsets.append((i, i + len(sp)))
                    i += len(sp)
                    break
            else:
                ids.append(ord(text[i]) % self.char_vocab)
                offsets.append((i, i + 1))
                i += 1
        return ids, offsets

    def encode(self, text: str) -> list[int]:
        return self.encode_with_offsets(text)[0]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for t in ids:
            t = int(t)
            if t in self.id_to_special:
                if not skip_special_tokens:
                    out.append(self.id_to_special[t])
            else:
                out.append(chr(t))
        return "".join(out)


class HFTokenizer:
    """A locally available HuggingFace fast tokenizer behind the surface of
    :class:`CharTokenizer`: ``<image>`` registered as an additional special
    token, bos/eos remapped to ``<|im_start|>`` / ``<|im_end|>``."""

    def __init__(self, pretrained: str):
        from transformers import AutoTokenizer  # local import: optional dep

        self.tok = AutoTokenizer.from_pretrained(
            pretrained, use_fast=True, padding_side="left", local_files_only=True
        )
        self.tok.add_special_tokens({"additional_special_tokens": ["<image>"]})
        self.bos_token, self.eos_token = BOS, EOS
        self.bos_token_id = self.tok.convert_tokens_to_ids(BOS)
        self.eos_token_id = self.tok.convert_tokens_to_ids(EOS)
        self.pad_token_id = self.tok.pad_token_id or self.eos_token_id
        self.vocab_size = len(self.tok)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.tok.convert_tokens_to_ids(token)

    def encode_with_offsets(self, text: str):
        enc = self.tok(text, return_offsets_mapping=True, add_special_tokens=False)
        return enc["input_ids"], [tuple(o) for o in enc["offset_mapping"]]

    def encode(self, text: str) -> list[int]:
        return self.tok(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


@dataclass
class StreamTokenizer:
    """The user-facing tokenizer object: backend + template config."""

    backend: object
    template: TemplateConfig = field(default_factory=TemplateConfig)

    @property
    def v_placeholder_id(self) -> int:
        return self.backend.convert_tokens_to_ids(self.template.v_placeholder)

    @property
    def eos_token_id(self) -> int:
        return self.backend.eos_token_id

    @property
    def pad_token_id(self) -> int:
        return self.backend.pad_token_id

    def apply_chat_template(self, conversation: list[dict], *, tokenize: bool = True, **kw):
        text = render_chat(conversation, self.template, **kw)
        if not tokenize:
            return text
        return self.backend.encode(text)

    def get_learn_ranges(self, conversation: list[dict]) -> list[range]:
        return get_learn_ranges(conversation, self.template)

    def encode_with_offsets(self, text: str):
        return self.backend.encode_with_offsets(text)

    def decode(self, ids, **kw) -> str:
        return self.backend.decode(ids, **kw)


def build_stream_tokenizer(
    pretrained: str | None = None,
    *,
    frame_num_tokens: int = 49,
    vocab_size: int = 512,
) -> StreamTokenizer:
    """Build a StreamTokenizer: HF-backed when a local vocab path is given,
    char-level otherwise (tests / synthetic runs)."""
    template = TemplateConfig(frame_num_tokens=frame_num_tokens)
    if pretrained is not None:
        backend = HFTokenizer(pretrained)
    else:
        backend = CharTokenizer(vocab_size=vocab_size)
    return StreamTokenizer(backend=backend, template=template)
