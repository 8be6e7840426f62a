"""Conversation prompt templating (the same templates as
`oryx_tpu.conversation`; tests/goldens pins both). Pure host-side code:
templates build the prompt strings that mm_utils.tokenizer_image_token()
then tokenizes.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto


class SeparatorStyle(Enum):
    PLAIN = auto()      # bare concatenation (stage-1 projector pretraining)
    TWO = auto()        # vicuna-style two separators
    CHATML = auto()     # Qwen/ChatML: <|im_start|>role\n...<|im_end|>\n
    LLAMA_2 = auto()    # [INST] <<SYS>>...<</SYS>> ... [/INST] reply </s>


@dataclasses.dataclass
class Conversation:
    """A left-to-right conversation being built into a prompt string."""

    system: str
    roles: tuple[str, str]
    messages: list[list[str | None]]
    sep_style: SeparatorStyle = SeparatorStyle.CHATML
    sep: str = "<|im_end|>\n"
    sep2: str | None = None
    version: str = "qwen"

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.CHATML:
            parts = []
            if self.system:
                parts.append(f"<|im_start|>system\n{self.system}{self.sep}")
            for role, msg in self.messages:
                if msg is None:
                    # Generation prompt: open the assistant turn.
                    parts.append(f"<|im_start|>{role}\n")
                else:
                    parts.append(f"<|im_start|>{role}\n{msg}{self.sep}")
            return "".join(parts)
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2 or self.sep]
            out = self.system + seps[0] if self.system else ""
            for i, (role, msg) in enumerate(self.messages):
                if msg is None:
                    # Trailing space matches the training-side prefix
                    # tokenization (train/data._template_parts emits
                    # "{role}: " unsupervised) — "ASSISTANT:" vs
                    # "ASSISTANT: " tokenize differently.
                    out += f"{role}: "
                else:
                    out += f"{role}: {msg}{seps[i % 2]}"
            return out
        if self.sep_style == SeparatorStyle.PLAIN:
            out = ""
            for _, msg in self.messages:
                if msg is not None:
                    out += msg + (self.sep or "")
            return out
        if self.sep_style == SeparatorStyle.LLAMA_2:
            # [INST] turn pairs; the system prompt rides inside the first
            # user turn's <<SYS>> block (llama-2-chat convention).
            sys_block = (
                f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" if self.system else ""
            )
            out = ""
            for i, (role, msg) in enumerate(self.messages):
                if role == self.roles[0]:
                    body = (sys_block + (msg or "")) if i == 0 else (msg or "")
                    out += f"{self.sep}[INST] {body} [/INST]"
                elif msg is None:
                    out += ""  # generation prompt: reply follows [/INST]
                else:
                    out += f" {msg} {self.sep2}"
            return out
        raise ValueError(f"unknown sep style {self.sep_style}")

    def append_message(self, role: str, message: str | None) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    @property
    def stop_str(self) -> str:
        if self.sep_style == SeparatorStyle.CHATML:
            return "<|im_end|>"
        if self.sep_style == SeparatorStyle.LLAMA_2:
            return self.sep2 or "</s>"
        return self.sep2 or self.sep


conv_qwen = Conversation(
    system="You are a helpful assistant.",
    roles=("user", "assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>\n",
    version="qwen",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    version="plain",
)

conv_vicuna = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. You are able to "
        "understand the visual content that the user provides, and assist "
        "the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_2",
)

conv_mistral = Conversation(
    # Mistral-Instruct: same [INST] wire format, no system block and
    # sep="" (the single leading BOS is the tokenizer's job, never a
    # mid-sequence literal — the reference registry's
    # conv_mistral_instruct row).
    system="",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
    version="mistral_instruct",
)

conv_llava_v1 = Conversation(
    # llava_v1's system differs from vicuna_v1 by two words
    # (human/human's vs user/user's) — checkpoints notice.
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="llava_v1",
)

conv_chatml_direct = Conversation(
    # ChatML with the short llava-v1.6-34b-style system.
    system="Answer the questions.",
    roles=("user", "assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>\n",
    version="chatml_direct",
)

conv_mpt = Conversation(
    # mpt-style system.
    system=(
        "A conversation between a user and an LLM-based AI assistant. "
        "The assistant gives helpful and honest answers."
    ),
    roles=("user", "assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>\n",
    version="mpt",
)

conv_templates: dict[str, Conversation] = {
    "qwen": conv_qwen,
    "qwen_1_5": conv_qwen,
    "plain": conv_plain,
    "v1": conv_vicuna,
    # LLaVA-family styles, so records/templates from sibling checkpoints
    # load unchanged.
    "llava_v1": conv_llava_v1,
    "vicuna_v1": conv_vicuna,
    "llava_llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral,
    "chatml_direct": conv_chatml_direct,
    "mpt": conv_mpt,
    # Yi-34B-Chat speaks ChatML with the same markers as Qwen.
    "yi_34b": conv_qwen,
}

default_conversation = conv_qwen
