r"""Guided (regex-constrained) decoding: regex -> byte DFA -> token masks
(the port of bioreason_tpu/generate/guided.py).

The host half is the JAX package's, copied: the regex is compiled to a
byte-level DFA (Thompson NFA -> subset construction -> reverse-reachability
trim, NumPy), then lifted to the token vocabulary, `next_state[s, tok]` =
the DFA state after tok's UTF-8 bytes from state s (the dead state if any
prefix rejects), vectorized over the whole vocabulary.

The device half is PyTorch: `GuidedSpec` holds the tables as tensors on an
explicit device, and at each decode step `mask_logits` gathers
`next_state[state]` ([B, V]) and masks the logits where the row is dead
(EOS allowed iff `accepting[state]`); after sampling, `advance` moves each
row's state. Neither syncs with the host.

Fullmatch semantics (like vLLM): the completion must match the whole regex;
EOS is only reachable from accepting states. The DFA is trimmed so every
live state can reach an accepting state: masking never leaves a row with no
allowed token and no EOS.

The table is as wide as the MODEL's vocabulary (`build_guided_spec`'s
`vocab_size`): a decoder head may have more rows than the tokenizer has ids
(Qwen3-0.6B's 151,936 against 151,669 tokens; a full-width head over the
266-token byte tokenizer). The JAX package sizes the table by the tokenizer
and its `jnp.where` against wider logits does not broadcast; here the
columns past the tokenizer's ids are dead, so an id the tokenizer cannot
decode is never allowed. Where the two sizes are equal the tables are the
JAX package's, bit for bit.

Supported syntax: literals (any unicode char, encoded as its UTF-8 byte
sequence), `.` (any byte except \n — exact for ASCII text, byte-approximate
for multi-byte codepoints), classes `[...]`/`[^...]` with ranges and escapes,
escapes `\d \D \w \W \s \S \n \t \r` + escaped punctuation, groups `(...)`
/ `(?:...)`, alternation `|`, quantifiers `* + ? {m} {m,} {m,n}` (laziness
suffix `?` accepted and ignored — same language), and `^`/`$` at the pattern
boundaries (no-ops under fullmatch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

NEWLINE = 0x0A
_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(range(0x30, 0x3A)) | frozenset(range(0x41, 0x5B)) | \
    frozenset(range(0x61, 0x7B)) | {0x5F}
_SPACE = frozenset(b" \t\n\r\x0b\x0c")
_ALL = frozenset(range(256))


# ---------------------------------------------------------------------------
# Regex parser -> AST
# ---------------------------------------------------------------------------

class _Node:
    pass


@dataclasses.dataclass
class _Lit(_Node):
    bytes_: frozenset            # set of allowed byte values (one position)


@dataclasses.dataclass
class _Seq(_Node):
    parts: list


@dataclasses.dataclass
class _Alt(_Node):
    options: list


@dataclasses.dataclass
class _Rep(_Node):
    child: _Node
    lo: int
    hi: Optional[int]            # None = unbounded


class RegexError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def next(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def parse(self) -> _Node:
        if self.p.startswith("^"):
            self.i += 1
        node = self.alt()
        if self.i < len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i} in {self.p!r}")
        return node

    def alt(self) -> _Node:
        opts = [self.concat()]
        while self.peek() == "|":
            self.next()
            opts.append(self.concat())
        return opts[0] if len(opts) == 1 else _Alt(opts)

    def concat(self) -> _Node:
        parts = []
        while self.peek() not in ("", "|", ")"):
            parts.append(self.repeat())
        return _Seq(parts)

    def repeat(self) -> _Node:
        node = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next(); node = _Rep(node, 0, None)
            elif c == "+":
                self.next(); node = _Rep(node, 1, None)
            elif c == "?":
                self.next(); node = _Rep(node, 0, 1)
            elif c == "{":
                save = self.i
                rep = self._try_brace()
                if rep is None:
                    self.i = save
                    break
                node = _Rep(node, rep[0], rep[1])
            else:
                break
            if self.peek() == "?":   # lazy suffix: same language, ignore
                self.next()
        return node

    def _try_brace(self) -> Optional[Tuple[int, Optional[int]]]:
        assert self.next() == "{"
        body = ""
        while self.peek() not in ("", "}"):
            body += self.next()
        if self.peek() != "}":
            return None
        self.next()
        import re as _re
        m = _re.fullmatch(r"(\d+)(,(\d*)?)?", body)
        if not m:
            return None
        lo = int(m.group(1))
        if m.group(2) is None:
            return lo, lo
        hi = int(m.group(3)) if m.group(3) else None
        if hi is not None and hi < lo:
            raise RegexError(f"bad repetition {{{body}}}")
        return lo, hi

    def atom(self) -> _Node:
        c = self.next()
        if c == "(":
            if self.peek() == "?":
                self.next()
                k = self.next()
                if k != ":":
                    raise RegexError(f"unsupported group (?{k}...)")
            node = self.alt()
            if self.next() != ")":
                raise RegexError("unbalanced parenthesis")
            return node
        if c == "[":
            return _Lit(self._char_class())
        if c == ".":
            return _Lit(frozenset(_ALL - {NEWLINE}))
        if c == "\\":
            return self._escape(in_class=False)
        if c == "$" and self.peek() in ("", "|", ")"):
            return _Seq([])      # end anchor at a boundary: no-op (fullmatch)
        if c in "*+?":
            raise RegexError(f"nothing to repeat at {self.i - 1}")
        # unmatched '{' falls through as a literal, like re
        return _literal_char(c)

    def _escape(self, in_class: bool):
        c = self.next()
        if c == "":
            raise RegexError("trailing backslash")
        table = {"d": _DIGITS, "D": _ALL - _DIGITS, "w": _WORD,
                 "W": _ALL - _WORD, "s": _SPACE, "S": _ALL - _SPACE}
        if c in table:
            s = frozenset(table[c])
            return s if in_class else _Lit(s)
        simple = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                  "0": 0x00}
        if c in simple:
            s = frozenset({simple[c]})
            return s if in_class else _Lit(s)
        if c == "x":
            hx = self.next() + self.next()
            s = frozenset({int(hx, 16)})
            return s if in_class else _Lit(s)
        if c.isalnum():
            raise RegexError(f"unsupported escape \\{c}")
        # escaped punctuation: literal
        if in_class:
            enc = c.encode("utf-8")
            if len(enc) != 1:
                raise RegexError(f"non-ASCII escape in class: {c!r}")
            return frozenset(enc)
        return _literal_char(c)

    def _char_class(self) -> frozenset:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        members: Set[int] = set()
        first = True

        def item() -> Tuple[frozenset, bool]:
            """One class member: (byte set, usable as a range endpoint)."""
            c = self.next()
            if c == "\\":
                got = self._escape(in_class=True)
                return got, len(got) == 1
            enc = c.encode("utf-8")
            if len(enc) != 1:
                raise RegexError(f"non-ASCII char in class: {c!r}")
            return frozenset(enc), True

        while True:
            c = self.peek()
            if c == "":
                raise RegexError("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            got, single = item()
            if (single and self.peek() == "-"
                    and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]"):
                self.next()                       # '-'
                hi_set, hi_single = item()
                if not hi_single:
                    raise RegexError("bad range end in class")
                lo, hi = next(iter(got)), next(iter(hi_set))
                if hi < lo:
                    raise RegexError("reversed range in class")
                members |= set(range(lo, hi + 1))
            else:
                members |= set(got)
        return frozenset(_ALL - members) if negate else frozenset(members)


def _literal_char(c: str) -> _Node:
    enc = c.encode("utf-8")
    if len(enc) == 1:
        return _Lit(frozenset(enc))
    return _Seq([_Lit(frozenset({b})) for b in enc])


# ---------------------------------------------------------------------------
# AST -> Thompson NFA -> DFA
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[frozenset, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int):
        self.eps[a].append(b)

    def add_edge(self, a: int, byteset: frozenset, b: int):
        self.edges[a].append((byteset, b))


def _build(nfa: _NFA, node: _Node) -> Tuple[int, int]:
    """Returns (start, accept) fragment states."""
    if isinstance(node, _Lit):
        s, a = nfa.state(), nfa.state()
        nfa.add_edge(s, node.bytes_, a)
        return s, a
    if isinstance(node, _Seq):
        s = nfa.state()
        cur = s
        for part in node.parts:
            ps, pa = _build(nfa, part)
            nfa.add_eps(cur, ps)
            cur = pa
        return s, cur
    if isinstance(node, _Alt):
        s, a = nfa.state(), nfa.state()
        for opt in node.options:
            os_, oa = _build(nfa, opt)
            nfa.add_eps(s, os_)
            nfa.add_eps(oa, a)
        return s, a
    if isinstance(node, _Rep):
        lo, hi = node.lo, node.hi
        s = nfa.state()
        cur = s
        for _ in range(lo):                       # mandatory copies
            ps, pa = _build(nfa, node.child)
            nfa.add_eps(cur, ps)
            cur = pa
        if hi is None:                            # Kleene tail
            ps, pa = _build(nfa, node.child)
            a = nfa.state()
            nfa.add_eps(cur, ps)
            nfa.add_eps(cur, a)
            nfa.add_eps(pa, ps)
            nfa.add_eps(pa, a)
            return s, a
        a = nfa.state()
        nfa.add_eps(cur, a)
        for _ in range(hi - lo):                  # optional copies
            ps, pa = _build(nfa, node.child)
            nfa.add_eps(cur, ps)
            cur = pa
            nfa.add_eps(cur, a)
        return s, a
    raise RegexError(f"unknown node {node}")


@dataclasses.dataclass
class RegexDFA:
    """Byte-level DFA. State 0 = start; state `dead` self-loops and rejects."""
    table: np.ndarray            # [S, 256] int32
    accepting: np.ndarray        # [S] bool
    dead: int
    pattern: str = ""

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    def fullmatch(self, data) -> bool:
        if isinstance(data, str):
            data = data.encode("utf-8")
        s = 0
        for b in data:
            s = int(self.table[s, b])
            if s == self.dead:
                return False
        return bool(self.accepting[s])


def compile_regex(pattern: str, max_states: int = 4096) -> RegexDFA:
    """Compile `pattern` (fullmatch semantics) to a trimmed byte DFA."""
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    start, accept = _build(nfa, ast)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset({start}))
    index: Dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        # group bytes by the set of NFA targets they reach (signature) so we
        # run closure once per distinct move, not 256 times
        moves: Dict[int, set] = {}
        for s in cur:
            for byteset, t in nfa.edges[s]:
                for b in byteset:
                    moves.setdefault(b, set()).add(t)
        row = np.full(256, -1, np.int64)
        sig_cache: Dict[frozenset, int] = {}
        for b, targets in moves.items():
            key = frozenset(targets)
            if key not in sig_cache:
                cl = closure(key)
                if cl not in index:
                    if len(index) >= max_states:
                        raise RegexError(
                            f"regex too large: >{max_states} DFA states")
                    index[cl] = len(order)
                    order.append(cl)
                sig_cache[key] = index[cl]
            row[b] = sig_cache[key]
        rows.append(row)
        i += 1

    n = len(order)
    dead = n
    table = np.full((n + 1, 256), dead, np.int32)
    for s, row in enumerate(rows):
        table[s] = np.where(row >= 0, row, dead)
    accepting = np.zeros(n + 1, bool)
    for s, st in enumerate(order):
        accepting[s] = accept in st

    # Trim: states that cannot reach an accepting state behave as dead.
    live = set(np.nonzero(accepting)[0].tolist())
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if s in live:
                continue
            if any(int(t) in live for t in np.unique(table[s]) if int(t) != dead):
                live.add(s)
                changed = True
    remap = np.full(n + 1, dead, np.int32)
    for s in range(n):
        if s in live:
            remap[s] = s
    table = remap[table]
    if 0 not in live:
        raise RegexError(f"regex {pattern!r} matches nothing")
    return RegexDFA(table=table, accepting=accepting, dead=dead, pattern=pattern)


# ---------------------------------------------------------------------------
# Token-level lifting
# ---------------------------------------------------------------------------

def token_bytes_for(tokenizer) -> List[bytes]:
    """Raw UTF-8 bytes each token id contributes to decoded text.

    The port's ByteTextTokenizer (ids 0..255 are raw bytes, atomic tokens
    their literal text) and its byte-level BPE (`data/bpe.py`: the GPT-2
    byte alphabet inverted; added and special tokens their literal text)."""
    from bioreason_tpu_torch.data.bpe import BPETokenizer
    from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer
    if isinstance(tokenizer, ByteTextTokenizer):
        out = [bytes([i]) for i in range(256)]
        out += [t.encode("utf-8") for t in tokenizer._atomic]
        return out
    if not isinstance(tokenizer, BPETokenizer):
        raise TypeError(f"guided decoding needs the port's ByteTextTokenizer or "
                        f"BPETokenizer, got {type(tokenizer).__name__}")
    byte_decoder = _gpt2_byte_decoder()
    out = []
    for i in range(tokenizer.vocab_size):
        tok_str = tokenizer.convert_ids_to_tokens(i)
        if tok_str is None:
            out.append(b"")
            continue
        try:
            out.append(bytes(byte_decoder[c] for c in tok_str))
        except KeyError:          # added/special token: literal text
            out.append(tok_str.encode("utf-8"))
    return out


def _gpt2_byte_decoder() -> Dict[str, int]:
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


@dataclasses.dataclass
class GuidedSpec:
    """Constraint tables for the decode loop, on one device."""
    next_state: torch.Tensor     # [S, V] int32; dead state self-loops
    accepting: torch.Tensor      # [S] bool
    dead: int
    eos_token_id: int

    def to(self, device) -> "GuidedSpec":
        return dataclasses.replace(self, next_state=self.next_state.to(device),
                                   accepting=self.accepting.to(device))


def build_guided_spec(dfa: RegexDFA, token_bytes: Sequence[bytes], eos_token_id: int,
                      disallowed_ids: Sequence[int] = (), vocab_size: Optional[int] = None,
                      device="cpu") -> GuidedSpec:
    """Lift a byte DFA to token-level gather tables (vectorized, host-side),
    [S, V] with V = `vocab_size` (the model's vocabulary; default
    len(token_bytes)), and put them on `device`.

    `disallowed_ids`: token ids never allowed regardless of bytes (special
    tokens like <|dna_pad|> whose text would otherwise match the regex).
    EOS is always mapped to a self-loop; the decode loop gates it on
    `accepting[state]`. Columns past len(token_bytes) are dead."""
    v = len(token_bytes)
    vocab_size = v if vocab_size is None else vocab_size
    if vocab_size < v:
        raise ValueError(f"the model's vocabulary ({vocab_size}) is smaller than the "
                         f"tokenizer's ({v})")
    lens = np.array([len(t) for t in token_bytes], np.int32)
    lmax = max(1, int(lens.max()))
    mat = np.zeros((v, lmax), np.uint8)
    for i, t in enumerate(token_bytes):
        if t:
            mat[i, :len(t)] = np.frombuffer(t, np.uint8)

    s_total = dfa.n_states
    next_state = np.full((s_total, vocab_size), dfa.dead, np.int32)
    for s in range(s_total):
        st = np.full(v, s, np.int32)
        for j in range(lmax):
            active = lens > j
            st = np.where(active, dfa.table[st, mat[:, j]], st)
        next_state[s, :v] = st
    # zero-byte tokens make no progress -> infinite loops; forbid them
    next_state[:, np.nonzero(lens == 0)[0]] = dfa.dead
    for i in disallowed_ids:
        next_state[:, i] = dfa.dead
    # EOS self-loops; allowance is gated on accepting[state]
    next_state[:, eos_token_id] = np.arange(s_total, dtype=np.int32)
    return GuidedSpec(next_state=torch.as_tensor(next_state, device=device),
                      accepting=torch.as_tensor(dfa.accepting, device=device),
                      dead=dfa.dead, eos_token_id=eos_token_id)


def guided_spec_for(tokenizer, pattern: str, vocab_size: Optional[int] = None,
                    device="cpu") -> GuidedSpec:
    """One-call helper: compile `pattern` and lift it over `tokenizer`, the
    table `vocab_size` columns wide (the model's vocabulary)."""
    dfa = compile_regex(pattern)
    tb = token_bytes_for(tokenizer)
    special = set(getattr(tokenizer, "_special_ids", ()) or ())
    special.discard(tokenizer.eos_token_id)
    return build_guided_spec(dfa, tb, tokenizer.eos_token_id,
                             disallowed_ids=sorted(special), vocab_size=vocab_size,
                             device=device)


def allowed(gstate: torch.Tensor, spec: GuidedSpec) -> torch.Tensor:
    """[B, V] bool: the tokens each row's DFA state allows (EOS iff the
    state is accepting)."""
    allow = spec.next_state[gstate.long()] != spec.dead
    allow[:, spec.eos_token_id] = spec.accepting[gstate.long()]
    return allow


def mask_logits(logits: torch.Tensor, gstate: torch.Tensor, spec: GuidedSpec) -> torch.Tensor:
    """Apply the constraint mask for the current per-row DFA states.

    logits [B, V], gstate [B] int -> masked logits. Disallowed tokens get
    -1e9 (finite: safe through top-k / softmax)."""
    return logits.masked_fill(~allowed(gstate, spec), -1e9)


def advance(gstate: torch.Tensor, tokens: torch.Tensor, spec: GuidedSpec) -> torch.Tensor:
    """gstate [B], tokens [B] -> next per-row DFA states (int32)."""
    return spec.next_state[gstate.long(), tokens.long()]
