"""The port's copy of the grammar compiler
(``accelerate_tpu_torch/serving/grammar.py``) held against the JAX
package's ``serving/grammar.py``: the same regexes and JSON schemas compile
to identical device tables (``padded_tables``, ``np.array_equal``), the
same start states, accepting and final states and hashes, and the same
specs are refused with the same messages."""

import numpy as np
import pytest

from accelerate_tpu.serving import grammar as jgrammar
from accelerate_tpu_torch.serving import grammar as tgrammar

SPECS = [
    {"type": "regex", "pattern": "ab+c"},
    {"type": "regex", "pattern": "[0-9]{1,4}"},
    {"type": "regex", "pattern": "(yes|no)!?"},
    {"type": "regex", "pattern": "[a-f]+x"},
    {"type": "json_schema", "schema": {"type": "integer"}},
    {"type": "json_schema", "schema": {"enum": ["red", "green"]}},
    {"type": "json_schema", "schema": {
        "type": "object", "properties": {"n": {"type": "integer"}, "ok": {"type": "boolean"}},
        "required": ["n", "ok"]}},
    {"type": "json_schema", "schema": {"type": "array", "items": {"type": "integer"}}},
]


@pytest.mark.parametrize("vocab, eos", [(128, None), (256, 0)])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.get("pattern") or str(s["schema"])[:30])
def test_grammars_compile_to_identical_tables(spec, vocab, eos):
    j = jgrammar.compile_grammar(spec, vocab, eos_id=eos, max_states=64)
    t = tgrammar.compile_grammar(spec, vocab, eos_id=eos, max_states=64)
    assert t.hash == j.hash == tgrammar.grammar_hash(spec)
    assert (t.start, t.num_states) == (j.start, j.num_states)
    np.testing.assert_array_equal(t.accepting, j.accepting)
    np.testing.assert_array_equal(t.final, j.final)
    for ta, ja in zip(t.padded_tables(64), j.padded_tables(64)):
        assert ta.dtype == ja.dtype and np.array_equal(ta, ja)


@pytest.mark.parametrize(
    "spec, vocab, max_states",
    [
        ({"type": "regex", "pattern": ""}, 64, None),
        ({"type": "json_schema"}, 64, None),
        ({"type": "bnf", "rules": "x"}, 64, None),
        ({"type": "json_schema", "schema": {"type": "boolean"}}, 64, None),
        ({"type": "regex", "pattern": "(ab"}, 256, None),
        ({"type": "regex", "pattern": "[0-9]{1,40}x"}, 256, 8),
        ({"type": "json_schema", "schema": {"type": "array"}}, 256, None),
        ({"type": "json_schema", "schema": {"type": "tuple"}}, 256, None),
    ],
)
def test_refusals_match_jax(spec, vocab, max_states):
    messages = []
    for pkg in (jgrammar, tgrammar):
        with pytest.raises(pkg.GrammarError) as err:
            pkg.compile_grammar(spec, vocab, eos_id=0, max_states=max_states)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_schema_regex_and_validator_match_jax():
    schema = SPECS[6]["schema"]
    assert tgrammar.schema_to_regex(schema) == jgrammar.schema_to_regex(schema)
    assert tgrammar.validate_instance(schema, {"n": 3, "ok": True}) is None
    for pkg in (jgrammar, tgrammar):
        with pytest.raises(pkg.GrammarError, match="missing property"):
            pkg.validate_instance(schema, {"n": 3})
