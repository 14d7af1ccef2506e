"""The byte tokenizer the configurations assume, worked out from its
layout alone: ids 0-255 are UTF-8 bytes, 256 BOS, 257 EOS, 258 PAD, and
the configuration's special tokens follow from 259 in their listed
order, each matched whole, longest first."""

from typing import Dict, List, Sequence

BOS, EOS, PAD = 256, 257, 258


def special_ids(specials: Sequence[str]) -> Dict[str, int]:
    return {tok: 259 + i for i, tok in enumerate(specials)}


def encode(text: str, specials: Sequence[str]) -> List[int]:
    ids = special_ids(specials)
    order = sorted(ids, key=len, reverse=True)
    out: List[int] = []
    i = 0
    while i < len(text):
        for tok in order:
            if text.startswith(tok, i):
                out.append(ids[tok])
                i += len(tok)
                break
        else:
            out.extend(text[i].encode("utf-8"))
            i += 1
    return out
