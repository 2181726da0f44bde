"""Constrained decoding: regexes and a JSON-schema subset compiled to
token-level DFAs (a copy of ``accelerate_tpu/serving/grammar.py``: numpy
and the standard library only, shared semantics).

The repo's serving stack works on a byte vocabulary (token id ``i`` is the
byte ``i``), so a grammar over characters IS a grammar over tokens: a
regex is parsed to a Thompson NFA over the byte alphabet, determinised,
and lowered to two dense tables —

* ``allow [num_states, vocab] bool`` — which tokens keep the prefix inside
  the language (i.e. lead to a *live* state, one from which an accepting
  state is still reachable), and
* ``trans [num_states, vocab] int32`` — the successor state per token.

Inside the engine those tables are rows of a device-resident
``[grammar_slots + 1, max_states, vocab]`` pair, written in place (the lane
graph holds their pointers); the per-slot DFA state is an int32 lane, and
mask application is one gathered ``torch.where(mask, logits, NEG)`` inside
the captured lane burst. Row 0 is the unconstrained sentinel (mask
all-True, transitions all-0), so unconstrained slots pay a no-op gather.

Compilation is cached process-wide by grammar hash
(:func:`compile_grammar`), and a JSON-schema subset lowers onto the same
regex pipeline by generating the canonical (no-whitespace, all properties
required, declaration order) textual form of the schema
(:func:`schema_to_regex`).  :func:`validate_instance` is a matching
minimal validator used by tests and the smoke harness — the ``jsonschema``
package is deliberately not a dependency.

Host-side, the authoritative DFA state lives on the request and advances
in ``_emit_token``; the on-device advance through ``trans`` only feeds
mid-burst masking, so a discarded burst tail can never corrupt the
request's real state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict

import numpy as np

__all__ = [
    "Grammar",
    "GrammarError",
    "compile_grammar",
    "compile_regex",
    "schema_to_regex",
    "validate_instance",
    "grammar_hash",
]


class GrammarError(ValueError):
    """Malformed grammar spec, unsupported construct, or a DFA that does
    not fit the engine's ``grammar_states`` budget."""


# --------------------------------------------------------------------------
# regex -> NFA (Thompson construction)
# --------------------------------------------------------------------------

_ESCAPE_CLASSES = {
    "d": frozenset(range(48, 58)),
    "w": frozenset(
        list(range(48, 58)) + list(range(65, 91)) + list(range(97, 123)) + [95]
    ),
    "s": frozenset(ord(c) for c in " \t\n\r\f\v"),
}


class _Nfa:
    def __init__(self):
        self.eps = []  # state -> set of eps targets
        self.edges = []  # state -> list of (charset, target)

    def new(self):
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1


def _parse_regex(pattern, alphabet):
    """Recursive-descent parse of the supported subset: literals, ``.``,
    ``[...]`` classes (ranges, negation), ``\\d \\w \\s`` escapes, grouping
    ``()``, alternation ``|``, quantifiers ``* + ?``."""
    nfa = _Nfa()
    i = 0
    n = len(pattern)

    def peek():
        return pattern[i] if i < n else None

    def _escape_set():
        nonlocal i
        i += 1  # consume backslash
        if i >= n:
            raise GrammarError(f"dangling escape at end of regex {pattern!r}")
        c = pattern[i]
        i += 1
        if c in _ESCAPE_CLASSES:
            return _ESCAPE_CLASSES[c] & alphabet
        if c == "n":
            return frozenset({10}) & alphabet
        if c == "t":
            return frozenset({9}) & alphabet
        if c == "r":
            return frozenset({13}) & alphabet
        return frozenset({ord(c)}) & alphabet

    def _class_set():
        nonlocal i
        i += 1  # consume '['
        negate = peek() == "^"
        if negate:
            i += 1
        chars = set()
        while True:
            c = peek()
            if c is None:
                raise GrammarError(f"unterminated character class in {pattern!r}")
            if c == "]":
                i += 1
                break
            if c == "\\":
                chars |= _escape_set()
                continue
            i += 1
            if peek() == "-" and i + 1 < n and pattern[i + 1] != "]":
                hi = pattern[i + 1]
                i += 2
                if ord(hi) < ord(c):
                    raise GrammarError(f"bad range {c}-{hi} in {pattern!r}")
                chars |= set(range(ord(c), ord(hi) + 1))
            else:
                chars.add(ord(c))
        cs = frozenset(chars) & alphabet
        return (alphabet - cs) if negate else cs

    def _atom():
        nonlocal i
        c = peek()
        if c == "(":
            i += 1
            frag = _alt()
            if peek() != ")":
                raise GrammarError(f"unbalanced parenthesis in {pattern!r}")
            i += 1
            return frag
        if c == "[":
            cs = _class_set()
        elif c == ".":
            i += 1
            cs = alphabet - {10}
        elif c == "\\":
            cs = _escape_set()
        elif c in ")|*+?":
            raise GrammarError(f"unexpected {c!r} at position {i} in {pattern!r}")
        else:
            i += 1
            cs = frozenset({ord(c)}) & alphabet
        s, e = nfa.new(), nfa.new()
        nfa.edges[s].append((cs, e))
        return s, e

    def _rep():
        nonlocal i
        s, e = _atom()
        while peek() in ("*", "+", "?"):
            q = peek()
            i += 1
            ns, ne = nfa.new(), nfa.new()
            nfa.eps[ns].add(s)
            nfa.eps[e].add(ne)
            if q in ("*", "+"):
                nfa.eps[e].add(s)
            if q in ("*", "?"):
                nfa.eps[ns].add(ne)
            s, e = ns, ne
        return s, e

    def _concat():
        frags = []
        while peek() is not None and peek() not in ")|":
            frags.append(_rep())
        if not frags:
            s, e = nfa.new(), nfa.new()
            nfa.eps[s].add(e)
            return s, e
        for (_, a_end), (b_start, _) in zip(frags, frags[1:]):
            nfa.eps[a_end].add(b_start)
        return frags[0][0], frags[-1][1]

    def _alt():
        nonlocal i
        frags = [_concat()]
        while peek() == "|":
            i += 1
            frags.append(_concat())
        if len(frags) == 1:
            return frags[0]
        s, e = nfa.new(), nfa.new()
        for fs, fe in frags:
            nfa.eps[s].add(fs)
            nfa.eps[fe].add(e)
        return s, e

    start, end = _alt()
    if i != n:
        raise GrammarError(f"trailing {pattern[i:]!r} in regex {pattern!r}")
    return nfa, start, end


# --------------------------------------------------------------------------
# NFA -> DFA -> dense tables
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grammar:
    """A compiled grammar: dense per-state tables sized for the engine.

    ``final[s]`` marks accepting states with no live continuation — the
    host finishes such a request immediately (``finish_reason="stop"``).
    When the engine has an eos token, accepting states additionally allow
    it (self-loop), so a model can terminate a still-extensible match.
    """

    hash: str
    vocab_size: int
    num_states: int
    start: int
    trans: np.ndarray  # [num_states, vocab] int32
    allow: np.ndarray  # [num_states, vocab] bool
    accepting: np.ndarray  # [num_states] bool
    final: np.ndarray  # [num_states] bool

    def advance(self, state, tok):
        """Host-side authoritative state transition."""
        return int(self.trans[state, tok])

    def allows(self, state, tok):
        return bool(self.allow[state, tok])

    def padded_tables(self, max_states):
        """(allow, trans) padded to ``[max_states, vocab]`` — unused rows
        are inert (all-allow, transition to 0) so a stale lane value can
        never produce an all-masked distribution."""
        if self.num_states > max_states:
            raise GrammarError(
                f"grammar needs {self.num_states} DFA states but the engine "
                f"budget is grammar_states={max_states}"
            )
        allow = np.ones((max_states, self.vocab_size), bool)
        trans = np.zeros((max_states, self.vocab_size), np.int32)
        allow[: self.num_states] = self.allow
        trans[: self.num_states] = self.trans
        return allow, trans


def compile_regex(pattern, vocab_size, eos_id=None, max_states=None, hash_=None):
    alphabet = frozenset(range(min(int(vocab_size), 0x110000)))
    nfa, nstart, nend = _parse_regex(pattern, alphabet)

    def closure(states):
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure({nstart})
    ids = {start_set: 0}
    worklist = [start_set]
    dfa_trans = []  # list of dict sym -> target id
    while worklist:
        cur = worklist.pop()
        move = {}
        for s in cur:
            for cs, t in nfa.edges[s]:
                for sym in cs:
                    move.setdefault(sym, set()).add(t)
        row = {}
        for sym, targets in move.items():
            tgt = closure(targets)
            if tgt not in ids:
                ids[tgt] = len(ids)
                dfa_trans.append(None)
                worklist.append(tgt)
            row[sym] = ids[tgt]
        idx = ids[cur]
        while len(dfa_trans) <= idx:
            dfa_trans.append(None)
        dfa_trans[idx] = row
    num_states = len(ids)
    if max_states is not None and num_states > max_states:
        raise GrammarError(
            f"regex {pattern!r} compiles to {num_states} DFA states, over the "
            f"grammar_states={max_states} budget"
        )

    accepting = np.zeros(num_states, bool)
    for sset, idx in ids.items():
        accepting[idx] = nend in sset

    # live = can still reach an accepting state
    live = accepting.copy()
    changed = True
    while changed:
        changed = False
        for s in range(num_states):
            if live[s]:
                continue
            if any(live[t] for t in (dfa_trans[s] or {}).values()):
                live[s] = True
                changed = True
    if not live[0]:
        raise GrammarError(f"regex {pattern!r} matches nothing over this vocabulary")

    vocab = int(vocab_size)
    trans = np.zeros((num_states, vocab), np.int32)
    allow = np.zeros((num_states, vocab), bool)
    for s in range(num_states):
        for sym, t in (dfa_trans[s] or {}).items():
            if sym < vocab and live[t]:
                allow[s, sym] = True
                trans[s, sym] = t
    final = accepting & ~allow.any(axis=1)
    if eos_id is not None and 0 <= int(eos_id) < vocab:
        e = int(eos_id)
        sel = accepting & ~allow[:, e]
        allow[sel, e] = True
        trans[sel, e] = np.arange(num_states)[sel]  # self-loop; host stops on eos

    return Grammar(
        hash=hash_ or hashlib.sha256(pattern.encode()).hexdigest()[:16],
        vocab_size=vocab,
        num_states=num_states,
        start=0,
        trans=trans,
        allow=allow,
        accepting=accepting,
        final=final,
    )


# --------------------------------------------------------------------------
# JSON-schema subset -> regex
# --------------------------------------------------------------------------

_REGEX_SPECIALS = set("\\.[](){}|*+?^$-")


def _lit(text):
    return "".join("\\" + c if c in _REGEX_SPECIALS else c for c in text)


# printable ASCII minus '"' and '\' — no escape sequences, no control
# bytes (they would make the emitted JSON unparseable); documented subset
_STRING_RE = '"[ !#-Z\\[\\]^-~]*"'
_INT_RE = "-?(0|[1-9][0-9]*)"
_NUMBER_RE = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?"


def schema_to_regex(schema):
    """Lower the supported JSON-schema subset to a regex over the
    *canonical* textual form: no whitespace, every declared property
    present in declaration order, strings without escape sequences.

    Supported: ``enum`` (of scalars), ``type`` in string / integer /
    number / boolean / null, ``object`` with ``properties`` (all treated
    as required), ``array`` with ``items``.  Anything else raises
    :class:`GrammarError`.
    """
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got {type(schema).__name__}")
    if "enum" in schema:
        opts = schema["enum"]
        if not opts:
            raise GrammarError("enum must be non-empty")
        return "(" + "|".join(_lit(json.dumps(v, separators=(",", ":"))) for v in opts) + ")"
    t = schema.get("type")
    if t == "string":
        return _STRING_RE
    if t == "integer":
        return _INT_RE
    if t == "number":
        return _NUMBER_RE
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        parts = [
            '"' + _lit(name) + '":' + schema_to_regex(sub)
            for name, sub in props.items()
        ]
        return "\\{" + ",".join(parts) + "\\}"
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarError("array schemas need 'items'")
        it = schema_to_regex(items)
        return "\\[(" + it + "(," + it + ")*)?\\]"
    raise GrammarError(f"unsupported schema: {schema!r}")


def validate_instance(schema, value):
    """Minimal validator matching exactly the subset
    :func:`schema_to_regex` supports (the ``jsonschema`` package is not a
    dependency).  Raises :class:`GrammarError` on mismatch."""
    if "enum" in schema:
        if value not in schema["enum"]:
            raise GrammarError(f"{value!r} not in enum {schema['enum']!r}")
        return
    t = schema.get("type")
    if t == "string":
        if not isinstance(value, str):
            raise GrammarError(f"expected string, got {value!r}")
    elif t == "integer":
        if not isinstance(value, int) or isinstance(value, bool):
            raise GrammarError(f"expected integer, got {value!r}")
    elif t == "number":
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise GrammarError(f"expected number, got {value!r}")
    elif t == "boolean":
        if not isinstance(value, bool):
            raise GrammarError(f"expected boolean, got {value!r}")
    elif t == "null":
        if value is not None:
            raise GrammarError(f"expected null, got {value!r}")
    elif t == "object":
        if not isinstance(value, dict):
            raise GrammarError(f"expected object, got {value!r}")
        props = schema.get("properties", {})
        for name, sub in props.items():
            if name not in value:
                raise GrammarError(f"missing property {name!r}")
            validate_instance(sub, value[name])
    elif t == "array":
        if not isinstance(value, list):
            raise GrammarError(f"expected array, got {value!r}")
        for item in value:
            validate_instance(schema.get("items", {}), item)
    else:
        raise GrammarError(f"unsupported schema: {schema!r}")


# --------------------------------------------------------------------------
# cached front door
# --------------------------------------------------------------------------

_CACHE = OrderedDict()
_CACHE_MAX = 128


def grammar_hash(spec):
    """Stable hash of a grammar spec dict (the cache key and the engine's
    row-assignment key)."""
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:16]


def compile_grammar(spec, vocab_size, eos_id=None, max_states=None):
    """Compile a grammar spec — ``{"type": "regex", "pattern": ...}`` or
    ``{"type": "json_schema", "schema": {...}}`` — to a :class:`Grammar`,
    memoised by (spec hash, vocab, eos, budget)."""
    if not isinstance(spec, dict) or "type" not in spec:
        raise GrammarError(
            'grammar spec must be {"type": "regex"|"json_schema", ...}, got '
            f"{spec!r}"
        )
    key = (grammar_hash(spec), int(vocab_size), eos_id, max_states)
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        return hit

    kind = spec["type"]
    if kind == "regex":
        pattern = spec.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError("regex grammar needs a non-empty 'pattern'")
    elif kind == "json_schema":
        schema = spec.get("schema")
        if not isinstance(schema, dict):
            raise GrammarError("json_schema grammar needs a 'schema' object")
        pattern = schema_to_regex(schema)
    else:
        raise GrammarError(f"unknown grammar type {kind!r}")

    g = compile_regex(
        pattern, vocab_size, eos_id=eos_id, max_states=max_states, hash_=key[0]
    )
    _CACHE[key] = g
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return g
