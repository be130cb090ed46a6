r"""Writes `data/unicode_classes.json`: the code point ranges of `\p{L}` and
`\p{N}` as the `regex` module reads them, for the byte-level BPE
(`data/bpe.py`), which runs on the standard library's `re` alone.

    python -m bioreason_tpu_torch.tools.unicode_classes

The JAX package compiles the tokenizer's split pattern with `regex`, whose
Unicode tables are newer than a Python's `unicodedata` can be; the BPE reads
this file in their place, so its pieces are the reference's. Run it where
`regex` is installed (the port itself never imports it) and commit the file
it writes; `tests/test_torch_pretrained.py` holds the file to `regex` on
every code point.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                    "unicode_classes.json")
NAMES = ("L", "N")


def _ranges(cps) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for c in cps:
        if out and c == out[-1][1] + 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [(a, b) for a, b in out]


def generate() -> Dict:
    """{"regex": its version, "L": [[first, last], ...], "N": [...]} from the
    installed `regex` module, over every code point 0..0x10FFFF."""
    import regex
    out = {"regex": regex.__version__}
    for name in NAMES:
        pat = regex.compile(rf"\p{{{name}}}")
        out[name] = [list(r) for r in _ranges(c for c in range(0x110000)
                                              if pat.match(chr(c)))]
    return out


def main() -> None:
    with open(PATH, "w") as f:
        json.dump(generate(), f, separators=(",", ":"))
        f.write("\n")
    print(PATH)


if __name__ == "__main__":
    main()
