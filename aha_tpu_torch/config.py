"""Configuration dataclasses of the port: model shapes, presets and the
streaming-inference flags.

The port's own copy of what it reads from ``aha_tpu/config.py`` (names,
fields and defaults kept, so a config of one package converts to the other
field by field): ``QwenConfig``, ``SiglipConfig``, ``AhaConfig`` with the
``aha_7b`` / ``aha_tiny`` presets, ``InferConfig``, and the training flags
``LossWeights``, ``LoraConfig`` and ``TrainConfig`` (with its mesh, ring and
pipeline fields; without ``vision_pretrained``, ``frame_fps``, ``frame_resolution``
and ``max_num_frames``, which nothing reads: the mixture's entries carry
their rate and frame count, the model config its frame size), with the CLIP
presets ``clip_large_336`` / ``clip_tiny``. The JSON helpers are not
carried.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class QwenConfig:
    """Qwen2-family decoder shape (transformers' Qwen2Config fields)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = True  # Qwen2 uses bias on q/k/v projections

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class SiglipConfig:
    """ViT vision tower shape; the default is
    google/siglip-large-patch16-384. ``arch='clip'`` is the CLIP tower
    (``models/clip.py``); ``use_head`` gives a SigLIP tower its MAP probe
    (``siglip.attention_pool``), which ``frame_token_cls`` needs."""

    image_size: int = 384
    patch_size: int = 16
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-6
    arch: str = "siglip"  # "siglip" | "clip"
    use_head: bool = False

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


@dataclass(frozen=True)
class AhaConfig:
    """Full multimodal model: vision tower + projector + decoder + 3 heads."""

    llm: QwenConfig = field(default_factory=QwenConfig)
    vision: SiglipConfig = field(default_factory=SiglipConfig)

    frame_resolution: int = 384
    frame_token_pooled: tuple[int, int] = (7, 7)
    frame_token_cls: bool = False
    v_placeholder: str = "<image>"
    v_placeholder_id: int = -1  # filled in by tokenizer build
    eos_token_id: int = -1      # filled in by tokenizer build
    pooling_mode: str = "average"  # average | max | bilinear
    # training ablation: the score heads see detached hidden states
    video_head_stop_grad: bool = False

    # dtype of the compute path ("bfloat16" on the card; tests use float32)
    dtype: str = "bfloat16"

    @property
    def frame_num_tokens(self) -> int:
        return self.frame_token_pooled[0] * self.frame_token_pooled[1] + (
            1 if self.frame_token_cls else 0
        )

    def replace(self, **kw) -> "AhaConfig":
        return dataclasses.replace(self, **kw)


# Presets -------------------------------------------------------------------


def qwen2_7b() -> QwenConfig:
    return QwenConfig()


def qwen2_tiny(vocab_size: int = 512) -> QwenConfig:
    """Tiny decoder for unit tests; same structural family as the 7B."""
    return QwenConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_position_embeddings=2048,
    )


def siglip_large_384() -> SiglipConfig:
    return SiglipConfig()


def siglip_tiny() -> SiglipConfig:
    return SiglipConfig(
        image_size=32,
        patch_size=16,
        hidden_size=32,
        intermediate_size=64,
        num_layers=2,
        num_heads=2,
    )


def clip_large_336() -> SiglipConfig:
    """openai/clip-vit-large-patch14-336."""
    return SiglipConfig(image_size=336, patch_size=14, layer_norm_eps=1e-5, arch="clip")


def clip_tiny() -> SiglipConfig:
    return SiglipConfig(image_size=32, patch_size=16, hidden_size=32, intermediate_size=64,
                        num_layers=2, num_heads=2, layer_norm_eps=1e-5, arch="clip")


def aha_7b() -> AhaConfig:
    return AhaConfig()


def aha_tiny(vocab_size: int = 512) -> AhaConfig:
    return AhaConfig(
        llm=qwen2_tiny(vocab_size),
        vision=siglip_tiny(),
        frame_resolution=32,
        frame_token_pooled=(1, 1),
        dtype="float32",
    )


# Training flags -------------------------------------------------------------


@dataclass
class LossWeights:
    """Loss mixing weights."""

    lm: float = 0.2
    video: float = 1.0
    info: float = 0.5
    relevance: float = 8.0
    uncertainty: float = 0.1
    tv: float = 0.05


@dataclass
class LoraConfig:
    """LoRA adapter shape."""

    r: int = 16
    alpha: int = 32
    dropout: float = 0.05
    # regex over flattened param paths, applied to decoder projections
    target_patterns: str = r"layers_\d+/(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel"
    # modules trained densely (not via adapters)
    finetune_modules: tuple[str, ...] = (
        "mm_projector",
        "lm_head",
        "informative_head",
        "relevance_head",
        "uncertainty_head",
    )


@dataclass
class TrainConfig:
    output_dir: str = "outputs/debug"
    dataset_config: str | None = None
    llm_pretrained: str | None = None       # path to converted weights, optional
    lora_pretrained: str | None = None

    learning_rate: float = 2e-5
    warmup_ratio: float = 0.05
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    batch_size: int = 1
    grad_accum_steps: int = 2
    num_epochs: int = 1
    seed: int = 42
    save_steps: int = 25
    save_total_limit: int = 5
    logging_steps: int = 1
    resume_from_checkpoint: str | None = None

    lora: LoraConfig = field(default_factory=LoraConfig)
    loss_weights: LossWeights = field(default_factory=LossWeights)

    # mesh shape: data (fsdp) x model (tensor) x pipe (pipeline stage) axes
    mesh_data: int = -1   # -1: all remaining ranks
    mesh_model: int = 1
    mesh_pipe: int = 1    # >1: GPipe over the decoder stack (parallel/pipeline.py)
    pipe_microbatches: int = 2  # GPipe microbatches per step (divides batch)

    # sequence-parallel ring attention: when on, batches whose padded length
    # reaches ring_min_seq run the decoder sequence-sharded over the data axis
    # (parallel/ring_attention.py)
    ring_attention: bool = False
    ring_min_seq: int = 2048

    # activation rematerialization of the decoder trunk
    # (models/qwen2.forward_hidden): "full" recomputes every layer's forward
    # in the backward (least memory), "half" every other layer's, "dots"
    # keeps the outputs of a layer's products (attention included) and
    # replays the elementwise work, "dots_no_batch" keeps the projections'
    # outputs only, "none" saves everything
    remat_policy: str = "full"   # none | full | half | dots | dots_no_batch

    system_prompt: str = (
        "A multimodal AI assistant is helping users with some activities."
        " Below is their conversation, interleaved with the list of video frames"
        " received by the assistant."
    )


# Inference flags -------------------------------------------------------------


@dataclass
class InferConfig:
    """Streaming inference flags."""

    system_prompt: str = (
        "A multimodal AI assistant is helping users with some activities."
        " Below is their conversation, interleaved with the list of video frames"
        " received by the assistant."
    )
    frame_fps: float = 2.0
    frame_resolution: int = 384
    max_num_frames: int | None = None

    grounding_mode: bool = False
    repetition_penalty: float | None = None

    # exactly one of the three stopping criteria may be set
    stream_end_prob_threshold: float | None = None
    threshold_z: float | None = None
    # suppress a new response within N frames of the previous one
    response_min_interval_frames: int | None = None
    stream_end_score_sum_threshold: float | None = None

    first_n_frames_no_generate: int = 0
    running_list_length: int = 20
    # accepted for flag parity with the reference's run scripts; read by no
    # decision
    consecutive_n_frames_threshold: int = 1
    uncertainty_wait_threshold: float = 0.0
    max_wait_frames: int = 3
    remove_assistant_turns: bool = False
    score_heads: tuple[str, ...] = ("relevance_score", "informative_score")
    max_new_tokens: int = 200

    # KV cache policy: "sink" | "sliding" | "static" | "none"
    kv_cache_policy: str = "sink"
    kv_window: int = 2048
    num_sink_tokens: int = 32
    # "auto" (model dtype) | "int8": per-(slot, head) quantized KV
    kv_cache_dtype: str = "auto"
    # speculative decoding: tokens verified per decoder pass (the carried
    # token + S-1 n-gram-lookup drafts). 1 = off (the plain sequential
    # loop). Exact greedy parity either way: acceptance replays the
    # sequential loop's argmax / eos / budget / penalty bookkeeping per
    # position (StreamEngine.generate_spec).
    spec_decode_tokens: int = 4
    # acceptance-adaptive ceiling: while the acceptance EMA is high the
    # verify chunk widens from spec_decode_tokens to this value, and narrows
    # back when acceptance drops. None or <= spec_decode_tokens = fixed
    # width.
    spec_decode_tokens_max: int | None = 8
    # "hf" (default): the reference's transformers-4.49 mask arithmetic,
    # incl. its post-fill intra-chunk non-causality (CachePolicy.mask_mode);
    # "strict": true causal order <= g
    kv_mask_mode: str = "hf"
    # multi-stream serving: the server's mixed loop returns to the host once this
    # many rows have reached their frame limit (or a response finished), so slots
    # are retired and refilled in batches (streaming/engine_serve.py); per-row
    # outputs are the same whatever the value
    retire_defer: int = 1
    # fused frame scoring: frames verified per decoder weight stream on the
    # scoring path (score_video). 1 = one pass per frame. Exact score and
    # cache parity either way (StreamEngine.append_frames_fused): frame
    # inputs are known in advance, so nothing can be rejected.
    fused_score_frames: int = 4

    def validate(self) -> None:
        n_set = sum(
            x is not None
            for x in (
                self.stream_end_prob_threshold,
                self.threshold_z,
                self.stream_end_score_sum_threshold,
            )
        )
        if not self.grounding_mode and n_set != 1:
            raise ValueError(
                "exactly one of stream_end_prob_threshold / threshold_z / "
                f"stream_end_score_sum_threshold must be set, got {n_set}"
            )
        if self.threshold_z is not None and self.first_n_frames_no_generate is None:
            raise ValueError("first_n_frames_no_generate required with threshold_z")
        if self.threshold_z is not None and not (
                isinstance(self.running_list_length, int)
                and self.running_list_length >= 2):
            raise ValueError(
                "threshold_z requires running_list_length >= 2 (a bounded "
                f"z-score window), got {self.running_list_length!r}")
        if self.kv_cache_policy not in ("sink", "sliding", "static", "none"):
            raise ValueError(f"unknown kv_cache_policy {self.kv_cache_policy}")
        if self.kv_mask_mode not in ("hf", "strict"):
            raise ValueError(f"unknown kv_mask_mode {self.kv_mask_mode}")
