"""Tokenizer layer.

Two backends behind one small interface:

  * HFTokenizer — wraps transformers AutoTokenizer when model files are
    on disk (the production path; parity with loader.py:88-138
    load_tokenizer incl. adding the 9 special tokens and resizing).
  * ByteTokenizer — self-contained byte-level tokenizer (no downloads),
    used by tests and smoke runs: 256 byte tokens + BOS/EOS/PAD +
    registered special tokens encoded as single ids.

Both expose: encode/decode, vocab_size, eos/pad ids,
additional_special_tokens_ids, and token_to_id for the control tokens.
"""

from typing import Dict, List, Optional, Sequence

from ..utils.constants import SPECIAL_TOKENS
from ..utils.logging import get_logger

logger = get_logger(__name__)


class ByteTokenizer:
    """Byte-level tokenizer with single-id special tokens.

    Layout: [0..255] raw bytes, 256=BOS, 257=EOS, 258=PAD, then template
    control tokens, then user-added special tokens.
    """

    def __init__(self, special_tokens: Optional[Sequence[str]] = None):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self._specials: Dict[str, int] = {}
        self._ids_to_special: Dict[int, str] = {}
        self.padding_side = "right"
        for tok in special_tokens or []:
            self.add_special_token(tok)

    def add_special_token(self, tok: str) -> int:
        if tok in self._specials:
            return self._specials[tok]
        idx = 259 + len(self._specials)
        self._specials[tok] = idx
        self._ids_to_special[idx] = tok
        return idx

    def add_special_tokens(self, toks: Sequence[str]) -> None:
        for t in toks:
            self.add_special_token(t)

    @property
    def vocab_size(self) -> int:
        return 259 + len(self._specials)

    @property
    def additional_special_tokens_ids(self) -> List[int]:
        return sorted(self._ids_to_special.keys())

    def token_to_id(self, tok: str) -> int:
        if tok not in self._specials:
            raise KeyError(f"unknown special token {tok!r}")
        return self._specials[tok]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special_tokens:
            ids.append(self.bos_token_id)
        i = 0
        # longest-first special-token matching
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            matched = False
            for tok in specials:
                if text.startswith(tok, i):
                    ids.append(self._specials[tok])
                    i += len(tok)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        buf = bytearray()

        def flush():
            nonlocal buf
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()

        for i in ids:
            i = int(i)
            if i < 256:
                buf.append(i)
            else:
                flush()
                if i in self._ids_to_special:
                    if not skip_special_tokens:
                        out.append(self._ids_to_special[i])
                elif not skip_special_tokens:
                    name = {256: "<bos>", 257: "<eos>", 258: "<pad>"}.get(i, "")
                    out.append(name)
        flush()
        return "".join(out)


class HFTokenizer:
    """Thin adapter over a transformers tokenizer instance."""

    def __init__(self, inner):
        self.inner = inner
        if inner.pad_token_id is None:
            inner.pad_token = inner.eos_token
        self.padding_side = inner.padding_side

    @property
    def bos_token_id(self):
        return self.inner.bos_token_id

    @property
    def eos_token_id(self):
        return self.inner.eos_token_id

    @property
    def pad_token_id(self):
        return self.inner.pad_token_id

    @property
    def vocab_size(self):
        return len(self.inner)

    @property
    def additional_special_tokens_ids(self):
        return self.inner.additional_special_tokens_ids

    def add_special_tokens(self, toks: Sequence[str]) -> None:
        self.inner.add_special_tokens(
            {"additional_special_tokens": list(toks)}, replace_additional_special_tokens=False)

    def token_to_id(self, tok: str) -> int:
        ids = self.inner.encode(tok, add_special_tokens=False)
        return ids[0]

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self.inner.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return self.inner.decode(list(map(int, ids)),
                                 skip_special_tokens=skip_special_tokens)


# the files an HF tokenizer directory holds (one is enough to try it)
_HF_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                       "tokenizer.model", "vocab.json", "vocab.txt")


def load_tokenizer(model_args, generate_mode: bool = False):
    """Load the tokenizer + register the 9 multimodal control tokens
    (parity: loader.py:88-138 — padding side right for train, left for
    generation; resize implied by added tokens).

    Falls back to ByteTokenizer when no HF tokenizer files exist (offline
    environments, tests, a from-scratch model directory that holds only
    its config.json).
    """
    import os
    tok = None
    path = model_args.tokenizer_path or model_args.model_name_or_path
    if path and any(os.path.exists(os.path.join(path, f))
                    for f in _HF_TOKENIZER_FILES):
        try:
            from transformers import AutoTokenizer
            inner = AutoTokenizer.from_pretrained(path)
            tok = HFTokenizer(inner)
        except Exception as e:  # pragma: no cover
            logger.warning("AutoTokenizer failed (%s); using ByteTokenizer", e)
    if tok is None:
        tok = ByteTokenizer()
    specials = model_args.special_token_list() or SPECIAL_TOKENS
    tok.add_special_tokens(specials)
    tok.padding_side = "left" if generate_mode else "right"
    return tok
