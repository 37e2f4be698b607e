"""Byte-level tokenizer front: sessions take TEXT, not token ids.

The minimal honest tokenizer (ROADMAP scenario-diversity prerequisite):
every UTF-8 byte ``b`` maps to token id ``b + 1``.  Id 0 stays reserved —
it is the engines' pad id and the controller's null-page sentinel, so a
prompt byte must never encode to it.  The front is a pure id<->text
codec: ``Session.submit``/``generate`` encode ``str`` prompts through it
and the existing token-id paths are untouched (a list of ints passes
straight through).

``decode(encode(s)) == s`` exactly for any ``str``.  Decoding ids the
model generated may leave the byte range (real vocabularies are larger
than 257) or form invalid UTF-8; both degrade to U+FFFD replacement
characters instead of raising — generation output is untrusted input.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

OFFSET = 1                       # id 0 = pad / null page, never a byte


class ByteTokenizer:
    """Exact byte<->id codec; needs a model vocab of at least 257."""

    vocab_needed = 256 + OFFSET

    def __init__(self, vocab: Optional[int] = None) -> None:
        if vocab is not None and vocab < self.vocab_needed:
            raise ValueError(
                f"byte tokenizer needs vocab >= {self.vocab_needed}, "
                f"got {vocab}")
        self.vocab = vocab

    def encode(self, text: str) -> List[int]:
        return [b + OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        buf = bytearray()
        for i in ids:
            if OFFSET <= i < 256 + OFFSET:
                buf.append(i - OFFSET)
            else:
                # out-of-byte-range model token: flush and substitute
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf.clear()
                out.append("�")
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)
