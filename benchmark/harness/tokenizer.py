"""A lossless stand-in tokenizer (the repository ships no tokenizer files).

`encode` gives a text's UTF-8 bytes as ids. `decode` writes every id as
one character of its own, chr(OFFSET + id), so a served reply maps back to
its token ids exactly: the code points are past the Basic Multilingual
Plane, where no character is whitespace (the engine strips a finished
reply) and none appears in a stop string."""

from __future__ import annotations

OFFSET = 0x10000


class CodepointTokenizer:
    def __init__(self, eos_token_id: int) -> None:
        self.eos_token_id = eos_token_id

    def encode(self, text, add_special_tokens=False):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        return "".join(
            chr(OFFSET + int(i)) for i in ids
            if not (skip_special_tokens and int(i) == self.eos_token_id)
        )


def ids_of(text: str) -> list[int]:
    """The token ids of a decoded reply."""
    return [ord(c) - OFFSET for c in text]
