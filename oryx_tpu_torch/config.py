"""Single dataclass-tree configuration, field for field the same as
`oryx_tpu.config`, so one `scripts/configs/*.json` loads into either package.

Every component takes its sub-config explicitly; the presets below pin the
published model geometries.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any

# Activation-checkpointing policies the training side understands ("none"
# is spelled remat=False in TrainConfig).
REMAT_POLICIES = ("none", "block", "dots", "attn", "attn_qkv", "attn_o")


@dataclass(frozen=True)
class LLMConfig:
    """Qwen2/Yi-class decoder geometry. Defaults are Qwen2-7B-Instruct (the
    Oryx-7B backbone)."""

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
    # Qwen2 uses bias on q/k/v projections (not o); Yi/Llama-class uses none.
    attention_bias: bool = True


@dataclass(frozen=True)
class VisionConfig:
    """OryxViT geometry: a SigLIP-so400m-patch14 derived encoder that accepts
    arbitrary (h, w) patch grids."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    head_dim: int = 72
    patch_size: int = 14
    # Side of the square grid the learned position embedding is stored at;
    # arbitrary grids are bilinearly interpolated from it (384px / 14).
    base_grid: int = 27
    layer_norm_eps: float = 1e-6
    num_channels: int = 3
    # Cap on patches per image; larger inputs are resized down to fit.
    max_patches_per_image: int = 4096


@dataclass(frozen=True)
class CompressorConfig:
    """Dynamic Compressor: region pooling + cross-attention + MLP projector
    into the LLM embedding space."""

    num_heads: int = 16
    # Downsample factors per spatial side; area compression is the square
    # (1 -> 1x, 2 -> 4x, 4 -> 16x).
    side_factors: tuple[int, ...] = (1, 2, 4)
    projector_hidden_layers: int = 2  # mlp2x_gelu-equivalent


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh axes (dp, fsdp, tp, sp); sizes of 1 collapse an
    axis. The port runs one rank a process (parallel/tp.py)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    projector_lr: float | None = None
    vision_lr: float | None = None
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    # Skip the optimizer update on steps whose loss or grad norm is
    # non-finite; abort after max_consecutive_skipped such steps in a row.
    skip_nonfinite_steps: bool = False
    max_consecutive_skipped: int = 20
    # Dtype for Adam's first moment ("float32" | "bfloat16").
    moment_dtype: str = "float32"
    global_batch_size: int = 128
    grad_accum_steps: int = 1
    num_train_steps: int = 1000
    length_group_size: int = 8
    seed: int = 0
    remat: bool = True
    remat_policy: str = "block"

    def __post_init__(self):
        allowed = tuple(p for p in REMAT_POLICIES if p != "none")
        if self.remat_policy not in allowed:
            raise ValueError(
                f"remat_policy={self.remat_policy!r}: use "
                f"{'|'.join(allowed)} (disable checkpointing with "
                "remat=False, not a policy)"
            )
        if self.moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"moment_dtype={self.moment_dtype!r}: use float32|bfloat16"
            )

    # Sequence-chunk size for the memory-efficient CE loss (0 = dense).
    loss_chunk: int = 128
    # Which parameter groups train: "full", "projector_only", "no_vision",
    # "lora".
    tune: str = "full"
    lora: "LoraConfig" = field(default_factory=lambda: LoraConfig())
    max_seq_len: int = 8192
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    log_every: int = 10


@dataclass(frozen=True)
class LoraConfig:
    """LoRA adapters on the decoder projections."""

    enable: bool = False
    r: int = 16
    alpha: float = 32.0
    # PEFT-compatible rank-stabilized scaling: alpha/sqrt(r) vs alpha/r.
    use_rslora: bool = False
    targets: tuple = ("q_proj", "k_proj", "v_proj", "o_proj")

    @property
    def scaling(self) -> float:
        return self.alpha / (self.r**0.5 if self.use_rslora else self.r)


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0
    top_k: int = 0
    eos_token_id: int = 151645  # <|im_end|> for Qwen2-Instruct


@dataclass(frozen=True)
class OryxConfig:
    """Root config for the multimodal model + runtime."""

    llm: LLMConfig = field(default_factory=LLMConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    compressor: CompressorConfig = field(default_factory=CompressorConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    # Compute dtype for matmuls/activations.
    dtype: str = "bfloat16"
    # "xla": the plain PyTorch attention (ops/attention.py) on any device.
    # "pallas": the hand-written flash-attention kernel on a CUDA tensor
    # (ops/cuda/flash_attention.py), its plain twin on a CPU tensor.
    attn_impl: str = "xla"
    # Optional text separator tokenized and spliced after EACH video
    # frame's visual span. None/"" = off (see models/splice.py).
    frame_separator: str | None = None

    # ---- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "OryxConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                unknown = set(val) - set(fields)
                if unknown:
                    raise ValueError(
                        f"unknown config key(s) for {tp.__name__}: "
                        f"{sorted(unknown)}"
                    )
                kwargs = {}
                for k, v in val.items():
                    ftype = _FIELD_TYPES.get((tp, k), None)
                    if ftype is not None:
                        v = build(ftype, v)
                    elif isinstance(v, list):
                        v = tuple(v)
                    kwargs[k] = v
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "OryxConfig":
        return cls.from_dict(json.loads(s))


def _collect_field_types(root):
    """Nested dataclass field types for from_dict, from the type hints, so
    arbitrarily nested configs (e.g. TrainConfig.lora) round-trip as
    dataclasses."""
    out, stack, seen = {}, [root], set()
    while stack:
        tp = stack.pop()
        if tp in seen:
            continue
        seen.add(tp)
        for name, hint in typing.get_type_hints(tp).items():
            if dataclasses.is_dataclass(hint):
                out[(tp, name)] = hint
                stack.append(hint)
    return out


_FIELD_TYPES = _collect_field_types(OryxConfig)


# ---- Presets ---------------------------------------------------------------

def qwen2_7b() -> LLMConfig:
    """Qwen2-7B-Instruct geometry (Oryx-7B backbone)."""
    return LLMConfig()


def yi_34b() -> LLMConfig:
    """Yi-34B geometry (Oryx-34B backbone): Llama-class, no attention bias."""
    return LLMConfig(
        vocab_size=64000,
        hidden_size=7168,
        intermediate_size=20480,
        num_layers=60,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=5_000_000.0,
        rms_norm_eps=1e-5,
        max_position_embeddings=32768,
        attention_bias=False,
    )


def qwen2_5_7b() -> LLMConfig:
    """Qwen2.5-7B-Instruct geometry (Oryx-1.5-7B backbone); tensor-identical
    to Qwen2-7B."""
    return LLMConfig()


def qwen2_5_32b() -> LLMConfig:
    """Qwen2.5-32B-Instruct geometry (Oryx-1.5-32B backbone)."""
    return LLMConfig(
        vocab_size=152064,
        hidden_size=5120,
        intermediate_size=27648,
        num_layers=64,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1_000_000.0,
        rms_norm_eps=1e-5,
        max_position_embeddings=32768,
        attention_bias=True,
    )


def tiny_llm(vocab_size: int = 512) -> LLMConfig:
    """Tiny geometry for tests (CPU-fast, GQA exercised)."""
    return LLMConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
        max_position_embeddings=512,
    )


def tiny_vision() -> VisionConfig:
    return VisionConfig(
        hidden_size=48,
        intermediate_size=96,
        num_layers=2,
        num_heads=4,
        head_dim=12,
        patch_size=14,
        base_grid=8,
        max_patches_per_image=256,
    )


def oryx_7b() -> OryxConfig:
    return OryxConfig(llm=qwen2_7b())


def oryx_34b() -> OryxConfig:
    return OryxConfig(llm=yi_34b())


def oryx_1_5_7b() -> OryxConfig:
    """Oryx-1.5-7B: Qwen2.5-7B backbone, same vision/compressor stack."""
    return OryxConfig(llm=qwen2_5_7b())


def oryx_1_5_32b() -> OryxConfig:
    """Oryx-1.5-32B: Qwen2.5-32B backbone, same vision/compressor stack."""
    return OryxConfig(llm=qwen2_5_32b())


def oryx_tiny() -> OryxConfig:
    return OryxConfig(
        llm=tiny_llm(),
        vision=tiny_vision(),
        compressor=CompressorConfig(num_heads=4),
        dtype="float32",
    )
