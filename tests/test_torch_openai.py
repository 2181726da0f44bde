"""The port's OpenAI front door (``accelerate_tpu_torch/serving/openai_api.py``)
against the JAX package's (``accelerate_tpu/serving/openai_api.py``).

Both ``OpenAIFrontend``s get the same request bodies and a submit function
that answers with the same result rows (streaming deltas included). The
engine payloads they build, their response bodies and their SSE frames
must be equal, with the random ``id`` and the clock's ``created``
normalised; the error objects of JAX's own tests
(``tests/test_sampling_serving.py``) come out the same from both. No engine
runs here: the translation is what is compared.
"""

import json

import pytest

from accelerate_tpu.serving import openai_api as jopenai
from accelerate_tpu_torch.serving import openai_api as topenai

#: the result row a request's submit answers with (the serve loop's shape)
RESULT = {
    "tokens": [104, 105, 33], "finish_reason": "length", "prompt_tokens": 5,
    "trace_id": "0af7651916cd43dd", "ttft_s": 0.25, "tpot_s": 0.01, "tenant": "acme",
    "device_time_s": 0.02, "kv_block_seconds": 0.5, "swap_bytes": 0,
    "logprobs": [{"token": 104, "logprob": -0.5, "top": [[104, -0.5], [1, -2.0]]},
                 {"token": 105, "logprob": -0.25, "top": [[105, -0.25], [2, -3.0]]},
                 {"token": 33, "logprob": -1.0, "top": [[33, -1.0], [3, -1.5]]}],
}

BODIES = {
    "completion_greedy": ("/v1/completions", {
        "prompt": "hello", "temperature": 0, "max_tokens": 4, "stop": ["X", "YZ"],
        "seed": 3, "x_accelerate_priority": "batch", "x_accelerate_deadline_ms": 500,
        "x_accelerate_trace_id": "0af7651916cd43dd", "x_accelerate_tenant": "acme"}),
    "completion_token_ids_sampled": ("/v1/completions", {
        "prompt": [1, 2, 3], "temperature": 0.7, "top_p": 0.9, "max_tokens": 8,
        "logprobs": 2}),
    "completion_json_schema": ("/v1/completions", {
        "prompt": "json:", "temperature": 0, "response_format": {
            "type": "json_schema",
            "json_schema": {"schema": {"type": "object",
                                       "properties": {"ok": {"type": "boolean"}},
                                       "required": ["ok"]}}}}),
    "chat": ("/v1/chat/completions", {
        "messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hi"}],
        "temperature": 0, "max_tokens": 3, "logprobs": True, "top_logprobs": 2}),
    "chat_default_sampling": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "model": "m1"}),
}


def _submit(sent, result, deltas=()):
    """A submit that records the payload, streams ``deltas`` through the
    payload's ``_stream`` when it has one, then answers ``result``."""

    def submit(payload, cb):
        sent.append({k: v for k, v in payload.items() if k != "_stream"})
        for chunk in deltas:
            if "_stream" in payload:
                payload["_stream"](chunk)
        cb(dict(result))

    return submit


def _normalise(obj):
    """Drop the random id and the clock from a response body or chunk."""
    if isinstance(obj, dict):
        return {k: ("<id>" if k == "id" and isinstance(v, str) and "cmpl-" in v
                    else "<created>" if k == "created" else _normalise(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalise(x) for x in obj]
    return obj


def _frames(events):
    out = []
    for frame in events:
        assert frame.startswith("data: ") and frame.endswith("\n\n")
        data = frame[6:-2]
        out.append(data if data == "[DONE]" else _normalise(json.loads(data)))
    return out


@pytest.mark.parametrize("case", list(BODIES))
def test_same_bodies_give_the_same_payloads_and_answers(case):
    path, body = BODIES[case]
    outs = []
    for module in (jopenai, topenai):
        sent = []
        front = module.OpenAIFrontend(_submit(sent, RESULT))
        kind, status, answer = front.handle(path, json.loads(json.dumps(body)))
        outs.append((sent, kind, status, _normalise(answer)))
    assert outs[0] == outs[1]
    sent, kind, status, answer = outs[1]
    assert (kind, status) == ("json", 200) and len(sent) == 1


@pytest.mark.parametrize("streaming", ["delta", "at_completion"])
@pytest.mark.parametrize("case", ["completion_greedy", "chat"])
def test_same_sse_frames(case, streaming):
    """Both streaming modes: deltas as the engine emits them, then one finish
    chunk carrying the tail and the usage, then ``[DONE]``."""
    path, body = BODIES[case]
    frames = []
    for module in (jopenai, topenai):
        sent = []
        front = module.OpenAIFrontend(_submit(sent, RESULT, deltas=([104], [105])),
                                      streaming=streaming)
        kind, events = front.handle(path, {**body, "stream": True})
        assert kind == "sse"
        frames.append(_frames(events))
    assert frames[0] == frames[1]
    got = frames[1]
    assert got[-1] == "[DONE]" and got.count("[DONE]") == 1
    finals = [f for f in got[:-1] if f["choices"][0]["finish_reason"]]
    assert len(finals) == 1 and finals[0]["usage"]["completion_tokens"] == 3


#: the error-object cases of the JAX package's own front-door tests
ERROR_CASES = [
    ("/v1/completions", {"prompt": "x", "n": 3}, "n"),
    ("/v1/completions", {"prompt": 42}, "prompt"),
    ("/v1/completions", {"prompt": "x", "temperature": 3.0}, "temperature"),
    ("/v1/completions", {"prompt": "x", "seed": "lucky"}, "seed"),
    ("/v1/completions", {"prompt": "x", "max_tokens": 0}, "max_tokens"),
    ("/v1/completions", {"prompt": "x", "response_format": {"type": "json_object"}},
     "response_format"),
    ("/v1/chat/completions", {"messages": []}, "messages"),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}], "tools": [{}]},
     "tools"),
]


@pytest.mark.parametrize("path, body, param", ERROR_CASES)
def test_error_objects_match_jax(path, body, param):
    answers = []
    for module in (jopenai, topenai):
        sent = []
        kind, status, out = module.OpenAIFrontend(_submit(sent, RESULT)).handle(path, body)
        assert sent == []  # refused before anything reaches the engine
        answers.append((kind, status, out))
    assert answers[0] == answers[1]
    kind, status, out = answers[1]
    assert (kind, status) == ("json", 400)
    assert out["error"]["type"] == "invalid_request_error" and out["error"]["param"] == param
    assert isinstance(out["error"]["message"], str) and out["error"]["message"]


def test_engine_error_rows_become_the_same_error_objects():
    answers = []
    for module in (jopenai, topenai):
        front = module.OpenAIFrontend(_submit([], {"error": "queue full"}))
        answers.append(front.handle("/v1/completions", {"prompt": "x"}))
        kind, events = front.handle("/v1/completions", {"prompt": "x", "stream": True})
        answers.append(_frames(events))
    assert answers[0] == answers[2] and answers[1] == answers[3]
    assert answers[2][1] == 400 and "queue full" in answers[2][2]["error"]["message"]


def test_byte_vocabulary_and_chat_template_match_jax():
    for text in ("hello", "héllo ✓", ""):
        assert topenai.encode_text(text) == jopenai.encode_text(text)
    tokens = [104, 195, 169, 255, 0, 300]
    assert topenai.decode_tokens(tokens) == jopenai.decode_tokens(tokens)
    messages = [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"}]
    assert topenai.chat_prompt(messages) == jopenai.chat_prompt(messages)
    assert topenai.OPENAI_PATHS == jopenai.OPENAI_PATHS
